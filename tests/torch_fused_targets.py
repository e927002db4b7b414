"""The repo's continuous targets that the fused kernels take, on both sides:
the JAX package's target, the port's target kind and parameters, a small
width, a step size and leapfrogs (tests/test_torch_fused_targets*.py); and
plain models of the dense tile kernels' blocked solves (K1's and K3's,
csrc/dense_tile.cuh), with the three TF32 passes of their panel products,
of the tile kernels' chain addressing (tests/test_torch_tile_hmc.py,
tests/test_torch_tile_mh.py), and of the order of sums of K3's logistic
kernel on its wide streamed and cluster paths (``cluster_density``,
tests/test_torch_fused_logistic_cluster.py)."""

import jax.numpy as jnp
import numpy as np
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.models.regression import HierarchicalLogistic as JaxLogistic
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_torch.convert import to_target

RTOL = 1e-10  # float64, the same formulas and draws: rounding only
MEAN2, COV2 = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])


def dense_cov(d):
    """``D R D`` with the headline's scales and ``R_ij = 0.5^|i−j|``."""
    scales = np.exp(np.linspace(0.0, np.log(10.0), d))
    idx = np.arange(d)
    return scales[:, None] * 0.5 ** np.abs(idx[:, None] - idx[None, :]) * scales[None, :]


def wishart_cov(d, seed=0):
    """The NUTS paper's multivariate normal (Hoffman & Gelman 2014, §4.1):
    the covariance whose precision is ``G Gᵀ``, ``G`` a ``d × d`` matrix of
    standard normals from ``np.random.default_rng(seed)`` (a Wishart draw of
    identity scale and ``d`` degrees of freedom), inverted in float64 and
    made symmetric.  At d = 250, seed 0: condition number 1.8e6, standard
    deviations 0.48 to 8.2."""
    G = np.random.default_rng(seed).standard_normal((d, d))
    cov = np.linalg.inv(G @ G.T)
    return 0.5 * (cov + cov.T)


def logistic_data(n_obs=32, p=6, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, p))
    beta = 0.5 * rng.normal(size=p)
    y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, y


def targets():
    """name -> (JAX target, the port's target kind and parameters, width,
    step size, leapfrogs): every target the fused kernels take beyond the
    diagonal GaussianND, at small widths."""
    X, y = logistic_data()
    cov4 = dense_cov(4)
    return {
        "diffable2d": (gmt.DiffableGaussian2D(mean=jnp.asarray(MEAN2), cov=jnp.asarray(COV2)),
                       ("DiffableGaussian2D", MEAN2, COV2), 2, 0.25, 5),
        "gaussian2d": (gmt.Gaussian2D(mean=jnp.asarray(MEAN2), cov=jnp.asarray(COV2)),
                       ("Gaussian2D", MEAN2, COV2), 2, 0.25, 5),
        "rosenbrock2d": (gmt.Rosenbrock2D(1.0, 10.0), ("Rosenbrock2D", 1.0, 10.0), 2, 0.05, 5),
        "rosenbrock_nd": (gmt.RosenbrockND(), ("RosenbrockND",), 5, 0.01, 5),
        "funnel": (gmt.NealsFunnel(6), ("NealsFunnel", 6, 3.0), 6, 0.2, 5),
        "dense_gaussian": (gmt.GaussianND(mean=jnp.zeros(4), cov=jnp.asarray(cov4)),
                           ("GaussianND", np.zeros(4), cov4), 4, 0.2, 5),
        "logistic_nc": (JaxLogisticNC(jnp.asarray(X), jnp.asarray(y)),
                        ("HierarchicalLogisticNC", X, y), 8, 0.05, 5),
        "logistic": (JaxLogistic(jnp.asarray(X), jnp.asarray(y)),
                     ("HierarchicalLogistic", X, y), 8, 0.05, 5),
    }


def port_target(spec, dtype):
    kind, *params = spec
    return to_target(kind, *params, dtype=dtype)


LAYOUTS = [(10, 4, 1), (5, 3, 3), (6, 0, 2)]  # tests/test_torch_fused_hmc.py's cases


BLOCK = 8  # columns of a block of csrc/fused_hmc_dense.cu's blocked solves
TILE = 16  # chains of a tile of csrc/tile_hmc.cuh


def tile_rows(tile, n, chain0):
    """The launch rows of the 16 rows of ``tile``, ``None`` where the row is
    padding (before row 0 or from ``n`` on), as csrc/tile_hmc.cuh's
    ``TileRows`` addresses them: tile ``k`` holds the global chains ``16
    (chain0 // 16 + k) …``, so a chain sits at row ``chain % 16`` of its
    tile whatever ``chain0`` is."""
    first = tile * TILE - chain0 % TILE
    return [r if 0 <= r < n else None for r in range(first, first + TILE)]


def launch_tiles(n, chain0):
    """Tiles of a launch of ``n`` rows from ``chain0`` (csrc/tile_hmc.cuh's
    ``launch_tiles``): from the start of chain0's tile to the end of the
    last row's."""
    return -(-(n + chain0 % TILE) // TILE)


def _padded(chol):
    d = chol.shape[-1]
    p = BLOCK * -(-d // BLOCK)
    out = torch.eye(p, dtype=chol.dtype, device=chol.device)
    out[:d, :d] = chol
    return out


def tf32_split(v):
    """``(hi, lo)`` of each value as the dense kernels split an operand for
    the tensor cores (csrc/logistic_tile.cuh, ``split_tf32``): the value in
    float32, ``hi`` its TF32 rounding (to nearest, ties away from zero: half
    of the last kept place added to the bit pattern, the 13 dropped bits
    cleared) and ``lo`` the TF32 rounding of the exact remainder; returned
    in ``v``'s dtype."""
    def round_tf32(f32):
        bits = (f32.view(torch.int32).to(torch.int64) + 0x1000) & 0xFFFFE000
        return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)

    f32 = v.to(torch.float32)
    hi = round_tf32(f32)
    lo = round_tf32(f32 - hi)
    return hi.to(v.dtype), lo.to(v.dtype)


def panel_3xtf32(a, b):
    """``a @ b`` as three TF32 passes (``mma_3x``): both operands split,
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, the ``lo × lo`` term dropped."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def blocked_forward(chol, r, panels="exact", order="right"):
    """``y = L⁻¹r`` for each row ``r`` of ``[n, d]``, in the dense tile
    kernels' order (csrc/dense_tile.cuh): the columns padded to blocks of 8
    (an identity block of ``L``); for each block, its diagonal block by
    substitution, ``y_i = (r_i − Σ_{j<i} L_ij y_j) · (1 / L_ii)``, and the
    panel products ``R_I −= Y_K L_IKᵀ``, either right-looking (``Solve::
    forward``: after block K is solved, taken off every later block) or
    left-looking (``WideSolve``, the streamed path: before block K is solved,
    the products of every solved block J < K taken off it, J in order); each
    element receives the same products in the same order either way.
    ``panels``: ``"exact"`` in ``r``'s dtype; ``"tf32"`` each panel product
    in the kernels' three TF32 passes (:func:`panel_3xtf32`); ``"rounded"``
    the MH kernel's float32 mode, in float32, every product and difference
    rounded, the diagonal block's terms ``j`` and a panel's columns in
    ascending order."""
    d = r.shape[-1]
    L = _padded(chol)
    if panels == "rounded":
        L, r = L.float(), r.float()
    y = torch.zeros(r.shape[:-1] + (L.shape[0],), dtype=r.dtype, device=r.device)
    y[..., :d] = r
    rd = 1.0 / torch.diagonal(L)
    panel = panel_3xtf32 if panels == "tf32" else torch.matmul

    def take(rows, cols):  # y[rows] -= the products of the solved columns `cols`
        if panels == "rounded":
            for j in range(cols.start, cols.stop):
                y[..., rows] = y[..., rows] - L[rows, j] * y[..., j:j + 1]
        else:
            y[..., rows] -= panel(y[..., cols], L[rows, cols].mT)

    for k in range(0, L.shape[0], BLOCK):
        s = slice(k, k + BLOCK)
        if order == "left":
            for j in range(0, k, BLOCK):
                take(s, slice(j, j + BLOCK))
        for i in range(k, k + BLOCK):
            if panels == "rounded":
                acc = y[..., i].clone()
                for j in range(k, i):
                    acc = acc - L[i, j] * y[..., j]
                y[..., i] = acc * rd[i]
            else:
                y[..., i] = (y[..., i] - y[..., k:i] @ L[i, k:i]) * rd[i]
        if order == "right":
            take(slice(k + BLOCK, L.shape[0]), s)
    return y[..., :d]


def column_forward(chol, r):
    """``y = L⁻¹r`` in float32 by columns, each product and difference
    rounded: ``y_i = r_i · (1 / L_ii)``, then ``r_j −= L_ji y_i`` for every
    ``j > i`` — the roundings of csrc/fused_mh.cu's lane solve, K3's dense
    path until the tile kernel."""
    L, y = chol.float(), r.float().clone()
    rd = 1.0 / torch.diagonal(L)
    for i in range(L.shape[0]):
        y[..., i] = y[..., i] * rd[i]
        y[..., i + 1:] = y[..., i + 1:] - L[i + 1:, i] * y[..., i:i + 1]
    return y


def blocked_log_density(target, x, panels="exact"):
    """The dense ``GaussianND``'s log density at ``x [n, d]`` as the MH tile
    kernel computes it (csrc/fused_mh_dense.cu): ``−½|y|²`` with ``y =
    L⁻¹(x − μ)`` by :func:`blocked_forward`."""
    y = blocked_forward(target.chol, x - target.mean, panels)
    return -0.5 * (y * y).sum(-1)


def blocked_back(chol, y, order="right"):
    """``w = L⁻ᵀy`` for each row, in the dense tile kernels' order: from the
    last block, its diagonal block by substitution from its last column,
    ``w_j = (y_j − Σ_{i>j} w_i L_ij) · (1 / L_jj)``, and the products ``Y_J
    −= W_K L_KJ``, right-looking (K1's resident kernel: after block K is
    solved, taken off every earlier block) or left-looking (the streamed
    path: before block K is solved, the products of every solved block I >
    K taken off it, I from the last)."""
    d = y.shape[-1]
    L = _padded(chol)
    n = L.shape[0]
    w = torch.zeros(y.shape[:-1] + (n,), dtype=y.dtype, device=y.device)
    w[..., :d] = y
    rd = 1.0 / torch.diagonal(L)
    for k in range(n - BLOCK, -1, -BLOCK):
        s = slice(k, k + BLOCK)
        if order == "left":
            for i in range(n - BLOCK, k, -BLOCK):
                si = slice(i, i + BLOCK)
                w[..., s] -= w[..., si] @ L[si, s]
        for j in range(k + BLOCK - 1, k - 1, -1):
            w[..., j] = (w[..., j] - w[..., j + 1:k + BLOCK] @ L[j + 1:k + BLOCK, j]) * rd[j]
        if order == "right":
            w[..., :k] -= w[..., s] @ L[s, :k]
    return w[..., :d]


def blocked_value_and_grad(target, x, order="right"):
    """``(log density, gradient)`` of the port's dense ``GaussianND`` at ``x
    [n, d]`` through :func:`blocked_forward` and :func:`blocked_back` in
    ``order``, the forward solve shared as in the kernel: ``−½|y|²`` and
    ``−L⁻ᵀy``."""
    y = blocked_forward(target.chol, x - target.mean, order=order)
    return -0.5 * (y * y).sum(-1), -blocked_back(target.chol, y, order)


def _quad(s):
    """A row's sum over the four lanes of its quad (the last axis), as two
    xor shuffles leave it in every lane: (s0 + s1) + (s2 + s3)."""
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def cluster_density(X, y, theta, centred, panel_rows=64):
    """The log density of each row of ``theta [n, p + 2]`` in the order of
    sums of K3's streamed and cluster paths (csrc/fused_mh_logistic.cu, head
    note), in ``theta``'s dtype (no TF32 split: a model of the order, not of
    the rounding).  The cluster: ``2 ceil(p / 16)`` feature tiles over the
    fewest blocks of at most 32 (one up to 256 features), block ``r`` the
    tiles from ``r tiles``; two warps a row tile, warp ``h`` the tiles of
    half ``h`` of its block (the first ``ceil(tiles / 2)``, then the rest)
    and half ``h`` of each panel's 8-observation tiles.

    - The prior's squares: a lane (``t``) over its own units in order, the
      unit's two elements of the row (features ``8 j + t``, ``8 j + t +
      4``) in order; the quad; warp 0 then warp 1; the blocks in rank
      order.
    - A logit: each block's feature tiles in order, then the blocks in
      rank order.
    - The log-likelihood (the exact softplus in float64): a lane over the
      panels of ``panel_rows`` observations, its warp's 8-observation tiles
      and its two observations ``8 u + 2 t``, ``8 u + 2 t + 1`` in order;
      the quad; warp 0 then warp 1.

    Returns ``[n]``: ``(((-mu^2/2 - (log tau)^2/2) - squares/2) [- p log
    tau]) + loglik`` in the kernels' ``log_density_nc`` /
    ``log_density_centred`` order."""
    X = torch.as_tensor(X, dtype=theta.dtype)
    y = torch.as_tensor(y, dtype=theta.dtype)
    n, d = theta.shape
    n_obs, p = X.shape
    pt = 2 * -(-p // 16)
    blocks = -(-pt // 32)
    tiles = -(-pt // blocks)
    halves = [(0, -(-tiles // 2)), (-(-tiles // 2), tiles)]
    width = 8 * tiles * blocks
    mu, lt, w = theta[:, 0], theta[:, 1], theta[:, 2:]
    tau = torch.exp(lt)
    beta = w if centred else mu[:, None] + tau[:, None] * w
    sq = ((w - mu[:, None]) / tau[:, None]) ** 2 if centred else w * w
    pad = lambda v: torch.cat([v, v.new_zeros(n, width - p)], dim=1)
    # [n, blocks, tiles, 2 (feature 8 j + t + 4 e), 4 (t)]
    sq = pad(sq).reshape(n, blocks, tiles, 2, 4)
    bt = pad(beta).reshape(n, blocks, tiles, 8)
    Xt = torch.cat([X, X.new_zeros(n_obs, width - p)], dim=1).reshape(n_obs, blocks, tiles, 8)
    squares = None
    for r in range(blocks):
        block = None
        for j0, j1 in halves:
            lane = theta.new_zeros(n, 4)
            for j in range(j0, j1):
                for e in range(2):
                    lane = lane + sq[:, r, j, e]
            block = _quad(lane) if block is None else block + _quad(lane)
        squares = block if squares is None else squares + block
    logits = None
    for r in range(blocks):
        acc = theta.new_zeros(n, n_obs)
        for j in range(tiles):
            acc = acc + bt[:, r, j] @ Xt[:, r, j].T
        logits = acc if logits is None else logits + acc
    terms = y * logits - torch.logaddexp(logits, torch.zeros((), dtype=logits.dtype))
    panels = -(-n_obs // panel_rows)
    nu = panel_rows // 16
    loglik = None
    for h in range(2):
        lane = theta.new_zeros(n, 4)
        for k in range(panels):
            for v in range(nu):
                for e in range(2):
                    obs = k * panel_rows + 8 * (h * nu + v) + 2 * torch.arange(4) + e
                    live = obs < n_obs
                    part = terms[:, obs.clamp(max=n_obs - 1)] * live.to(terms.dtype)
                    lane = lane + part
        loglik = _quad(lane) if loglik is None else loglik + _quad(lane)
    prior = ((-0.5 * mu) * mu - (0.5 * lt) * lt) - 0.5 * squares
    if centred:
        prior = prior - p * lt
    return prior + loglik
