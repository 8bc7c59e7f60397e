from aurora_tpu_torch.ops.tome import (  # noqa: F401
    bipartite_soft_matching,
    kth_bipartite_soft_matching,
    merge_source,
    merge_wavg,
    random_bipartite_soft_matching,
    tome_schedule,
)
