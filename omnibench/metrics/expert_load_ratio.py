"""The busiest expert's tokens over the mean expert's, in the MoE layers
of the window's untraced ticks: the program's ``moe.expert_tokens_max``
(the largest group of each MoE call, which sizes its expert batch) over
``moe.expert_tokens`` (the token-expert picks of each call) divided by
the configuration's routed experts.  1 is an even load; the experts'
batched products run at this multiple of the work the picks need."""

from omnibench.program_spans import counter_per_tick


def read(run):
    picks = counter_per_tick(run, "moe.expert_tokens")
    if not picks:
        return None
    busiest = counter_per_tick(run, "moe.expert_tokens_max")
    return busiest / (picks / run.config["n_routed_experts"])
