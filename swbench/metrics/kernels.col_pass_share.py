"""kernels.col_pass_share: of the passes that the col kernels' warps
would run at their buckets' padded L, the share they ran, each warp
stopping at its own subject's length, in %: the col wrappers'
``col_warp_passes`` over ``col_bucket_passes`` (``score_bucket_col``,
``score_bucket_col_flat`` and ``score_bucket_col_flat_fused``), launched
on the card since the process started, set-up's warm-up included.  100
where every subject fills its bucket's passes; None off the card, or
where the engine counts no pass (an engine without the counters among
them)."""


def read(run):
    if run.device_name == "cpu":
        return None
    from cudasw4_tpu_torch.ops import sw_col

    wrappers = (sw_col.score_bucket_col, sw_col.score_bucket_col_flat,
                sw_col.score_bucket_col_flat_fused)
    warp = sum(getattr(w, "col_warp_passes", 0) for w in wrappers)
    full = sum(getattr(w, "col_bucket_passes", 0) for w in wrappers)
    return 100.0 * warp / full if full else None
