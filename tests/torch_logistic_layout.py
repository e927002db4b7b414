"""What the card tests hold the logistic tile kernels' host layout to
(``launch_layout`` of ``ops/fused_hmc_logistic.py`` and
``ops/fused_mh_logistic.py``, read from each kernel's own host code): the
path a shape takes and the streamed path's panels; and the pilot rule that
picks K1's step size for a check, shared with chip_smoke.py's logistic
phases.  No JAX."""

from general_mcmc_torch.ops import fused_hmc_logistic, fused_mh_logistic
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


# K3's streamed path past K3_WIDE features and its cluster path
# (csrc/fused_mh_logistic.cu): row tiles a cluster (kMT: 5 streamed, 4 on
# clusters), the most ring stages (kMaxStages) and the most observations a
# panel (kPanelRows)
K3_WIDE = fused_mh_logistic.ROW_TILE_FEATURES
K3_PANEL_ROWS, K3_MAX_STAGES = 64, 4


def k3_row_tiles(p: int) -> int:
    """K3's row tiles a cluster at ``p`` features past K3_WIDE."""
    return 5 if p <= fused_hmc_logistic.MAX_BLOCK_FEATURES else 4


def check_k3_layout(lay: dict, n_obs: int, p: int, streamed: int) -> None:
    """K3's ``lay`` (``ops/fused_mh_logistic.py``) takes the path
    ``streamed`` within one block's shared memory: resident, and streamed
    up to K3_WIDE features, as ``check_layout`` says (beside two producer
    warps a block); past K3_WIDE features ``k3_row_tiles(p)`` row tiles a
    cluster of ``cluster_blocks`` blocks of at most 256 features each (one
    up to 256), no producer warps, panels of a multiple of 32 observations,
    at most K3_PANEL_ROWS, that cover ``n_obs`` with less than one panel to
    spare, one stage where one panel holds them (kept), else 2 to
    K3_MAX_STAGES, from a float32 copy of X and y (each block's slice 8
    tiles + ROW_PAD floats a row), and at least one cluster in flight."""
    if not streamed or p <= K3_WIDE:
        check_layout(lay, n_obs, p, streamed)
        assert lay["producer_warps"] == 2 and lay["in_flight"] >= 1, lay
        return
    assert lay["streamed"] == 1 and lay["producer_warps"] == 0, lay
    assert lay["tiles_a_block"] == k3_row_tiles(p), lay
    assert lay["shared_bytes"] <= MAX_SHARED_BYTES, lay
    clusters = -(-p // 256)
    per_block = 8 * -(-fused_hmc_logistic.feature_tiles(p) // clusters)
    assert lay["cluster_blocks"] == clusters and lay["features_a_block"] == per_block, lay
    assert lay["blocks"] == clusters * -(-lay["tiles"] // lay["tiles_a_block"]), lay
    rows, panels, stages = lay["panel_rows"], lay["panels"], lay["stages"]
    assert rows % 32 == 0 and 32 <= rows <= K3_PANEL_ROWS, lay
    assert (panels - 1) * rows < n_obs <= panels * rows, lay
    assert stages == 1 if panels == 1 else 2 <= stages <= min(panels, K3_MAX_STAGES), lay
    words = rows * (per_block + ROW_PAD + 1)
    assert lay["scratch_words"] == clusters * panels * words, lay
    assert lay["shared_bytes"] >= 4 * stages * words, lay
    assert lay["in_flight"] >= 1, lay


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
