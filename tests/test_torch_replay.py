"""The port's replay lane (``repro_torch.serving.replay`` and the
``python -m repro_torch.launch.replay`` CLI) against the reference's.

* record -> check in the port, through the CLI (``main(argv)``).
* Across packages: a corpus recorded by ``repro.launch.replay record``
  passes ``repro_torch.launch.replay check``, and the reverse, for a
  closed sync corpus, a closed async corpus with pod-level allocation,
  an open-loop corpus with SLO admission, a mixed-task corpus and a
  2-pod fleet corpus; the two packages write byte-equal JSONL logs for
  each spec.
* ``diff`` and ``report`` print the reference's lines.
* A tampered log makes ``check`` exit 1 with the drift list, in both
  directions.
* ``replay`` on event lists, the policy override, and the spec's schema
  (after ``tests/test_telemetry.py``'s replay classes).
"""

from __future__ import annotations

import json

import pytest

from repro.launch import replay as j_cli
from repro.serving import replay as j_replay
from repro_torch.launch import replay as t_cli
from repro_torch.serving import replay as t_replay
from repro_torch.serving.replay import CorpusSpec, record, replay
from repro_torch.serving.runtime import SyncTickPolicy
from repro_torch.serving.telemetry import JsonlSink, MemorySink

# the CLI arguments of each corpus (``record``'s flags)
CORPORA = {
    "closed-sync": ["--streams", "4", "--frames", "6"],
    "closed-async-pod-allocate": ["--streams", "8", "--frames", "6",
                                  "--policy", "async", "--pod-allocate"],
    "open-slo": ["--streams", "6", "--open-loop", "--fps", "1.0",
                 "--horizon", "10", "--slo", "2.0", "--admission", "slo"],
    "mixed-tasks": ["--streams", "6", "--open-loop", "--tasks", "mixed",
                    "--horizon", "12", "--slo", "2.0", "--admission", "slo"],
    "fleet-2-pods": ["--streams", "8", "--open-loop", "--pods", "2",
                     "--routing", "affinity", "--horizon", "12"],
}
CLI = {"repro": j_cli, "repro_torch": t_cli}


def _run(cli, argv, capsys) -> tuple[int, list[str]]:
    capsys.readouterr()
    rc = cli.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def _record(cli, name, tmp_path, capsys):
    path = tmp_path / f"{cli.__name__}-{name}.jsonl"
    rc, lines = _run(cli, ["record", "--out", str(path)] + CORPORA[name],
                     capsys)
    assert rc == 0 and lines[0].startswith("recorded ")
    return path, lines


@pytest.mark.parametrize("name", list(CORPORA))
def test_record_then_check_in_the_port(name, tmp_path, capsys):
    path, _ = _record(t_cli, name, tmp_path, capsys)
    rc, lines = _run(t_cli, ["check", str(path)], capsys)
    assert rc == 0, lines
    assert len(lines) == 1 and "bit-identical" in lines[0]


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
@pytest.mark.parametrize("name", list(CORPORA))
def test_cross_package_check(name, direction, tmp_path, capsys):
    """A log recorded by one package checks bit-identical in the other,
    with the same verdict line as the recording package's own check."""
    rec_pkg, chk_pkg = direction.split("->")
    path, rec_lines = _record(CLI[rec_pkg], name, tmp_path, capsys)
    rc, lines = _run(CLI[chk_pkg], ["check", str(path)], capsys)
    assert rc == 0, lines
    _, own = _run(CLI[rec_pkg], ["check", str(path)], capsys)
    assert lines == own
    assert "bit-identical" in lines[0]
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    spec = events[0]["spec"]
    if name == "mixed-tasks":
        assert set(spec["tasks"]) == {"detection", "action_recognition"}
    if name == "fleet-2-pods":
        assert (spec["pods"], spec["routing"]) == (2, "affinity")
        assert any(e["event"] == "route" for e in events)


@pytest.mark.parametrize("name", list(CORPORA))
def test_logs_are_byte_equal(name, tmp_path, capsys):
    j_path, j_lines = _record(j_cli, name, tmp_path, capsys)
    t_path, t_lines = _record(t_cli, name, tmp_path, capsys)
    assert t_path.read_bytes() == j_path.read_bytes()
    assert [ln.rsplit(" -> ", 1)[0] for ln in t_lines] == \
        [ln.rsplit(" -> ", 1)[0] for ln in j_lines]


@pytest.mark.parametrize("args", [["--policy", "deadline"],
                                  ["--policy", "async", "--admission", "slo"],
                                  ["--admission", "admit-all"]],
                         ids=["deadline", "async-slo", "admit-all"])
@pytest.mark.parametrize("name", ["closed-async-pod-allocate", "mixed-tasks"])
def test_diff_lines_match_reference(name, args, tmp_path, capsys):
    path, _ = _record(j_cli, name, tmp_path, capsys)
    j_rc, j_lines = _run(j_cli, ["diff", str(path)] + args, capsys)
    t_rc, t_lines = _run(t_cli, ["diff", str(path)] + args, capsys)
    assert (t_rc, t_lines) == (j_rc, j_lines)
    assert t_lines[0].startswith("policy diff")


@pytest.mark.parametrize("name", ["open-slo", "fleet-2-pods"])
def test_report_lines_match_reference(name, tmp_path, capsys):
    path, _ = _record(t_cli, name, tmp_path, capsys)
    j_rc, j_lines = _run(j_cli, ["report", str(path)], capsys)
    t_rc, t_lines = _run(t_cli, ["report", str(path)], capsys)
    assert (t_rc, t_lines) == (j_rc, j_lines)
    assert t_rc == 0 and t_lines


def test_diff_needs_a_policy(tmp_path, capsys):
    path, _ = _record(t_cli, "closed-sync", tmp_path, capsys)
    rc, _ = _run(t_cli, ["diff", str(path)], capsys)
    assert rc == 2


def test_fleet_record_needs_open_loop(tmp_path, capsys):
    rc, _ = _run(t_cli, ["record", "--out", str(tmp_path / "x.jsonl"),
                         "--pods", "2"], capsys)
    assert rc == 2
    assert not (tmp_path / "x.jsonl").exists()


def _tamper(path):
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    for e in events:
        if e["event"] == "run_stats":
            stats = e["stats"]
            if "pods" in stats:
                stats["pods"][0]["frames"] += 1
            else:
                stats["frames"] += 1
    path.write_text("".join(json.dumps(e) + "\n" for e in events))


@pytest.mark.parametrize("checker", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", ["closed-sync", "fleet-2-pods"])
def test_tampered_log_fails_check(name, checker, tmp_path, capsys):
    path, _ = _record(t_cli, name, tmp_path, capsys)
    _tamper(path)
    rc, lines = _run(CLI[checker], ["check", str(path)], capsys)
    assert rc == 1
    assert lines[0] == "replay DRIFTED from its recording:"
    assert any("recorded" in ln and "replayed" in ln for ln in lines[1:])


# -- the replay module --------------------------------------------------------


OPEN = CorpusSpec(mode="open", n_streams=4, frames=4, devices=4,
                  policy="async", admission="slo", slo_s=2.0, fps=1.0,
                  jitter=0.2, horizon_s=8.0, churn=((3.0, 1, False),
                                                    (6.0, 1, True)),
                  rate_trace=((0.0, 1.0), (4.0, 2.0)))


def test_replay_of_an_event_list_with_churn_is_identical():
    sink = MemorySink()
    stats = record(OPEN, sink)
    result = replay(sink.events)
    assert result.identical, result.drift()
    assert result.replayed_stats["arrivals"] == stats.arrivals
    assert result.spec == OPEN
    # the reference replays the port's records identically as well
    j_result = j_replay.replay(sink.events)
    assert j_result.identical, j_result.drift()
    assert j_result.replayed_stats == result.replayed_stats


def test_policy_override_is_a_diff_not_an_identity(tmp_path):
    path = tmp_path / "closed.jsonl"
    record(CorpusSpec(mode="closed", n_streams=4, frames=5, devices=4,
                      policy="async"), JsonlSink(str(path)))
    result = replay(str(path), policy=SyncTickPolicy())
    assert not result.same_policy
    assert result.replayed_stats["policy"] == "sync"
    lines = t_replay.format_policy_diff(result)
    j_result = j_replay.replay(str(path),
                               policy=j_replay._spec_policy(
                                   j_replay.CorpusSpec(policy="sync")))
    assert lines == j_replay.format_policy_diff(j_result)
    assert t_replay.fingerprint_metrics(result.replayed_stats) == \
        j_replay.fingerprint_metrics(j_result.replayed_stats)


def test_replay_requires_spec_and_stats():
    sink = MemorySink()
    record(CorpusSpec(mode="closed", n_streams=2, frames=2, devices=0),
           sink)
    with pytest.raises(ValueError, match="corpus_spec"):
        replay([e for e in sink.events if e["event"] != "corpus_spec"])
    with pytest.raises(ValueError, match="run_stats"):
        replay([e for e in sink.events if e["event"] != "run_stats"])


def test_spec_round_trips_and_matches_reference():
    for spec in (OPEN, CorpusSpec(tasks=("detection", "action_recognition"),
                                  n_streams=2, pods=2, routing="affinity",
                                  mode="open", budget_s=[1.0, 2.0])):
        d = spec.to_dict()
        assert CorpusSpec.from_dict(d) == spec
        assert j_replay.CorpusSpec.from_dict(d).to_dict() == d
        assert json.dumps(d) == json.dumps(
            j_replay.CorpusSpec.from_dict(d).to_dict())
    with pytest.raises(ValueError, match="unknown fields"):
        CorpusSpec.from_dict({"bogus": 1})
    with pytest.raises(ValueError, match="open"):
        t_replay.build_fleet(CorpusSpec(mode="closed", pods=2))
