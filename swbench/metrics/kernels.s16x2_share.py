"""kernels.s16x2_share: of the exact cell-kernel slots (a B1 launch is
one, a B4 launch one a slot with rows) that the engine launched on the
card since the process started, set-up's warm-up with its window's shapes
included, the share that ``sw_cell16_kernel`` scored in s16x2 lanes,
in %: the wrappers' ``s16x2_slots`` over ``s16x2_slots + int32_slots``
(``cuda_lib.count_slots``).  None off the card, or where the engine
counts no such slot (an engine without the counters among them)."""


def read(run):
    if run.device_name == "cpu":
        return None
    from cudasw4_tpu_torch.ops import sw_cell

    wrappers = (sw_cell.score_bucket_cell, sw_cell.score_bucket_cell_batch)
    s16 = sum(getattr(w, "s16x2_slots", 0) for w in wrappers)
    s32 = sum(getattr(w, "int32_slots", 0) for w in wrappers)
    return 100.0 * s16 / (s16 + s32) if s16 + s32 else None
