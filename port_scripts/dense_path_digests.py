"""The dense tile kernels' store digests on their resident paths (K1 up to
168 dimensions, K3 up to 240), for the package under a given root:
chip_smoke.py's ``dense_path_digests`` (K1 at 100 and 168, K3 at 100 and 240
with the random walk and pCN, 512 chains x 64 steps), run against a parent
tree to give "dense-wide"'s ``DENSE_PATH_DIGESTS``.

    git archive <parent> | tar -x -C build/parent
    python3 port_scripts/dense_path_digests.py build/parent
    python3 port_scripts/dense_path_digests.py .

Run from the repo root on a machine with one CUDA card and ``nvcc``; the
package is imported from the root given, chip_smoke.py's function from
this tree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.abspath(sys.argv[1]))

import torch  # noqa: E402

import general_mcmc_torch  # noqa: E402

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))


def main() -> None:
    if not os.path.abspath(general_mcmc_torch.__file__).startswith(os.path.abspath(sys.argv[1])):
        raise SystemExit(f"general_mcmc_torch came from {general_mcmc_torch.__file__}")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE)
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = chip_smoke  # its dataclasses look their module up
    spec.loader.exec_module(chip_smoke)
    print(general_mcmc_torch.__file__)
    print(json.dumps(chip_smoke.dense_path_digests(torch.device("cuda", 0))))


if __name__ == "__main__":
    main()
