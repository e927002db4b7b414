"""The designs K3's logistic tile kernel (``csrc/fused_mh_logistic.cu`` on
``csrc/tile_mh.cuh`` and ``csrc/logistic_tile.cuh``) was timed against, as
splices of this tree's sources into a copy of the package under ``build/``
(git ignores it), so that the shipped sources carry one design only.

    warps-1        one solver warp a tile, all the observations (the
                   tile_mh.cuh default, the dense kernel's): 8 warps a
                   block
    obs-64         each warp's pass over 64 observations, eight
                   accumulator chains, where the shipped kernel takes 32
    producers-3    three producer warps a block (tile_mh.cuh's default), 13
                   warps: four on one scheduler, 128 registers a warp
    softplus-none  a diagnostic, not a design: the softplus replaced by the
                   logit itself (another density, so other chains), to
                   time what the softplus costs

Each splice is an exact text replacement that must match once, so a change
to the shipped sources that a splice no longer fits fails loudly.
:func:`make` writes the copy (``general_mcmc_torch/`` and ``chip_smoke.py``)
and returns its root; ``port_scripts/logistic_family_designs.py`` takes
``--variant NAME``.
"""

from __future__ import annotations

import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = "general_mcmc_torch/csrc/fused_mh_logistic.cu"
HEADER = "general_mcmc_torch/csrc/logistic_tile.cuh"

PASS = ("constexpr int kObsPass = 32;  // observations a warp's pass: four 8-observation "
        "accumulator chains")

VARIANTS = {
    "warps-1": [(KERNEL, "constexpr int kWarps = 2;", "constexpr int kWarps = 1;")],
    "producers-3": [(KERNEL, "constexpr int kProducers = 2;", "constexpr int kProducers = 3;")],
    "obs-64": [
        (KERNEL, PASS, "constexpr int kObsPass = 64;  // eight accumulator chains"),
        (KERNEL, "gmt_logistic::forward_loglik<kPT>(", "gmt_logistic::forward_loglik<kPT, 8>("),
    ],
    "softplus-none": [
        (HEADER, "  const float sp = l > 20.0f ? l : log1pf(expf(l));", "  const float sp = l;"),
    ],
}


def splice(text: str, old: str, new: str) -> str:
    """``text`` with ``old`` replaced by ``new``, which must match once."""
    if text.count(old) != 1:
        raise ValueError(f"splice does not match once: {old[:60]!r}")
    return text.replace(old, new)


def make(name: str, out: Path | None = None) -> Path:
    """A copy of this tree's package and chip_smoke.py with variant ``name``
    spliced in, under ``build/k3_logistic_variants/<name>`` unless ``out``
    is given; returns its root."""
    root = out or ROOT / "build" / "k3_logistic_variants" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(ROOT / "general_mcmc_torch", root / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", root / "chip_smoke.py")
    for rel, old, new in VARIANTS[name]:
        path = root / rel
        path.write_text(splice(path.read_text(), old, new))
    return root
