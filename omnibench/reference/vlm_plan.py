"""The region-description ladder as the latency model prices it: a
frozen copy of ``repro_torch.serving.tasks.vlm_ladder`` (one model read
at four crop sizes; gav tables from the detection table's generator
under the task's seed, 11; the edge seconds of a request at each rung).
The plan's delays and knapsack are ``omnibench.reference.plan``'s."""

from __future__ import annotations

from omnibench.reference.plan import N_CATEGORIES, Variant, synthetic_gav_table

# (name, crop size, edge seconds of one request)
VLM_LADDER = (
    ("kimivl-224", 224, 0.15),
    ("kimivl-448", 448, 0.4),
    ("kimivl-672", 672, 0.8),
    ("kimivl-896", 896, 1.4),
)


def make_ladder(n_categories: int = N_CATEGORIES,
                sizes=None) -> list[Variant]:
    """The ladder, at ``sizes`` where given (a configuration's own crop
    sizes, which the projection and upload prices follow)."""
    gavs = synthetic_gav_table(len(VLM_LADDER), n_categories, 11)
    sizes = sizes or [size for _, size, _ in VLM_LADDER]
    return [Variant(name, i + 1, size, "edge", gavs[i], infer_s)
            for i, ((name, _, infer_s), size)
            in enumerate(zip(VLM_LADDER, sizes, strict=True))]
