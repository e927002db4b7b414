"""ChEES at German credit's shape on the CPU: the witness beside
chip_smoke.py's "logistic-german", whose ChEES runs on the card.

``chip_smoke.german_posterior`` on ``torch.device("cpu")``: the same data
(``make_logistic_data(7, 1000, 24)``), ``--chains`` chains (10,240, the
card's, by default) from ``init_with_seed(..., 0)``, seed 0 and ChEES's
settings, 512 warmup and 512 collected steps; the draws are the fill
kernel's plain version, but the products sum in the CPU's order (and
ChEES's adaptation averages over the chains), so the run agrees with the
card's in distribution only.  Prints the spread witness:
the pooled collection's sd over the last draws' (the in-run statistics',
the mapped betas'), by quarter of the collection, the draws past
``LGG_FAR`` sds, and the divergences.

    python3 port_scripts/chees_german_spread.py [--threads N] [--chains N]

Run from the repo root; no card is needed.  At 10,240 chains it did not
end within 14 minutes on four threads of an 8-core host beside other work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4, help="torch threads on the CPU")
    ap.add_argument("--chains", type=int, default=10_240, help="ChEES's chains")
    args = ap.parse_args()
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        # german_posterior synchronises the card around its timing
        torch.cuda.synchronize = lambda *a, **k: None
    chip_smoke.N_CHAINS = args.chains
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    chees, _ = chip_smoke.german_posterior(torch.device("cpu"))
    chees["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"device": "cpu", "chains": chip_smoke.N_CHAINS, **chees}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
