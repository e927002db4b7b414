"""Terminal progress display for sampling runs.

The port's own copy of ``general_mcmc_tpu/utils/progress.py`` (the port
imports nothing of the JAX package): a global bar plus up to five chain
bars, annotated with the streaming acceptance estimate and max R-hat, the
same strings and the same rotation of the chain bars.  Chains advance in
lockstep, so every chain bar shares one position.  Rendering is throttled
(default 4 Hz) and writes ANSI to stderr; a run without progress makes no
callback at all.
"""

from __future__ import annotations

import sys
import time

__all__ = ["ProgressRenderer"]

_BAR_WIDTH = 40


def _bar(prefix: str, pos: int, total: int, msg: str) -> str:
    frac = 0.0 if total == 0 else min(pos / total, 1.0)
    filled = int(frac * _BAR_WIDTH)
    bar = "=" * filled + (">" if filled < _BAR_WIDTH else "") + "-" * max(
        _BAR_WIDTH - filled - 1, 0
    )
    return f"{prefix:<8} [{bar}] {pos}/{total} | {msg}"


class ProgressRenderer:
    """Multi-bar progress renderer (≤5 chain bars + global, 1 Hz stats)."""

    def __init__(self, n_chains: int, total_steps: int, max_bars: int = 5,
                 min_interval: float = 0.25, stream=None):
        self.n_chains = n_chains
        self.total = total_steps
        self.n_bars = min(n_chains, max_bars)
        self.min_interval = min_interval
        self.stream = stream if stream is not None else sys.stderr
        self._last_draw = 0.0
        self._lines = 0
        self._local_rotation = 0

    def update(self, done: int, tracker=None):
        now = time.monotonic()
        if done < self.total and now - self._last_draw < self.min_interval:
            return
        self._last_draw = now
        msg = ""
        p_chain = None
        start = 0
        if tracker is not None:
            try:
                p_acc = tracker.p_accept
                max_rhat = tracker.max_rhat()
                msg = f"p(accept)≈{p_acc:.2f} max(rhat)≈{max_rhat:.2f}"
            except Exception:  # pragma: no cover - display only
                msg = ""
            # per-chain acceptance for the chain bars (core.rs:288-306);
            # entries < 0 mean "no step observed yet" and display blank
            p_chain = getattr(tracker, "p_accept_chain", None)
            # Chain-bar rotation (core.rs:288-296, 344-360): a tracker may
            # supply the window's start index (stream mode rotates on
            # device); otherwise rotate locally, one chain per redraw.
            start = getattr(tracker, "p_accept_chain_start", None)
            if start is None:
                start = self._local_rotation
                if self.n_chains > self.n_bars:
                    self._local_rotation = (start + 1) % self.n_chains
            else:
                start = int(start)
        # Explicit flag (not a length heuristic: a rotated window of length
        # n_chains would be misindexed): stream mode pre-rotates on device
        # and sets p_chain_is_window; the chunked tracker exposes the full
        # chain-indexed array.
        is_window = bool(getattr(tracker, "p_chain_is_window", False))
        lines = [_bar("Global", done * self.n_chains, self.total * self.n_chains, msg)]
        for i in range(self.n_bars):
            idx = (start + i) % self.n_chains
            cmsg = ""
            if p_chain is not None and i < len(p_chain):
                j = i if is_window else idx
                if float(p_chain[j]) >= 0.0:
                    cmsg = f"p(accept)≈{float(p_chain[j]):.2f}"
            lines.append(_bar(f"Chain {idx}", done, self.total, cmsg))
        self._draw(lines)

    def _draw(self, lines):
        out = ""
        if self._lines:
            out += f"\x1b[{self._lines}F"  # cursor up to first bar line
        out += "\x1b[J" + "\n".join(lines) + "\n"
        self.stream.write(out)
        self.stream.flush()
        self._lines = len(lines)

    def close(self):
        if self._lines:
            self.stream.write("\n")
            self.stream.flush()
