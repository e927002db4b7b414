"""What the card tests hold the logistic tile kernels' host layout to
(``launch_layout`` of ``ops/fused_hmc_logistic.py`` and
``ops/fused_mh_logistic.py``, read from each kernel's own host code): the
path a shape takes and the streamed path's panels; and the pilot rule that
picks K1's step size for a check, shared with chip_smoke.py's logistic
phases.  No JAX."""

from general_mcmc_torch.ops import fused_hmc_logistic
from general_mcmc_torch.ops.fused_logistic import MAX_SHARED_BYTES

MAX_PANEL_ROWS, STAGES, ROW_PAD = 256, 2, 4  # kMaxRows, kStages, kRowPad of the sources


def check_layout(lay: dict, n_obs: int, p: int, streamed: int) -> None:
    """``lay`` takes the path ``streamed`` within one block's shared memory:
    resident, X's TF32 hi and lo and y (at least) in the block; or streamed,
    in panels of a multiple of 32 observations, at most MAX_PANEL_ROWS, that
    cover ``n_obs`` with less than one panel to spare, through STAGES ring
    stages, from a split copy of the panels' X hi, lo and y (rows 8 PT +
    ROW_PAD floats apart)."""
    pt = fused_hmc_logistic.feature_tiles(p)
    assert lay["streamed"] == streamed, lay
    assert 1 <= lay["tiles_a_block"] and lay["shared_bytes"] <= MAX_SHARED_BYTES, lay
    if streamed:
        rows, panels = lay["panel_rows"], lay["panels"]
        assert rows % 32 == 0 and 32 <= rows <= MAX_PANEL_ROWS, lay
        assert (panels - 1) * rows < n_obs <= panels * rows, lay
        assert lay["stages"] == STAGES, lay
        assert lay["scratch_words"] == panels * rows * (2 * (8 * pt + ROW_PAD) + 1), lay
        assert lay["shared_bytes"] >= 4 * STAGES * rows * (2 * (8 * pt + ROW_PAD) + 1), lay
    else:
        assert lay["panel_rows"] == lay["panels"] == lay["stages"] == 0, lay
        assert lay["scratch_words"] == 0, lay
        assert lay["shared_bytes"] >= 4 * n_obs * (2 * 8 * pt + 1), lay


def largest_step(accept_at, steps, floor: float):
    """The first of ``steps`` (largest first) whose pilot accept,
    ``accept_at(step)``, is at least ``floor``, else the last; and the
    accepts read, by step."""
    read = {}
    for step in steps:
        read[step] = accept_at(step)
        if read[step] >= floor:
            break
    return step, read
