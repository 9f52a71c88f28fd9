"""The card's peaks and the roofline arithmetic of the kernels' work.

The work every implementation has to do is the real cells: query residues
x real subject residues.  A cell costs at least 4 operations at two cells a
32-bit lane operation (packed 16-bit halves): one each for E and F, two for
H, with the running maximum over cell pairs folded in, which is below the
4.5 a DPX recurrence spends.  So no kernel, int32 or s16x2, can read over
100% of this bound.  Bytes: each tile byte of the database read once a
scan.
"""

from __future__ import annotations

#: Operations a real cell needs, and cells a 32-bit lane operation.
OPS_PER_CELL = 4
CELLS_PER_LANE_OP = 2

#: Published peaks by ``torch.cuda.get_device_name()``: SMs, 32-bit
#: integer lanes an SM, the top SM clock (MHz) and the HBM rate (bytes/s),
#: at the card's full power limit (NVIDIA's H100 SXM data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "int32_lanes": 64, "clock_mhz": 1980,
                              "hbm_bytes_per_s": 3.35e12},
}


def least_seconds(device_name: str, cells: float, nbytes: float, ndev: int = 1):
    """The least time ``ndev`` cards of ``device_name`` could take for
    ``cells`` real cells and ``nbytes`` read: the larger of the operation
    and the byte bound, or None for a card not in ``PEAKS``."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    lane_ops_per_s = peak["sms"] * peak["int32_lanes"] * peak["clock_mhz"] * 1e6 * ndev
    t_ops = cells * OPS_PER_CELL / CELLS_PER_LANE_OP / lane_ops_per_s
    t_bytes = nbytes / (peak["hbm_bytes_per_s"] * ndev)
    return max(t_ops, t_bytes)
