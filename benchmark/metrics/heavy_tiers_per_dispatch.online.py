"""K4's size-tier launches a dispatch: the program's ``gp_tier_launches``
counter (one a size tier of a GP dispatch: the base tier of models of up to
128 points and, where a dispatch holds denser blocks, the overflow tier)
over its ``dispatches`` counter, both while the profiler recorded
(``la3dm_tpu_torch/utils/profiling.py``).  A program without the counter
reads nothing."""


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    counts = snapshot()["counts"]
    if not counts.get("dispatches") or "gp_tier_launches" not in counts:
        return None
    return counts["gp_tier_launches"] / counts["dispatches"]
