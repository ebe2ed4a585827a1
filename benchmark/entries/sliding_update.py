"""A request is one update of a sliding MODWT: new samples for every stream
arrive as a host array, ``sliding_modwt_update`` advances the state, and
the new coefficient columns are read back to the host.

The mix gives ``streams``, ``window``, ``chunk`` (new samples a stream and
update) and ``distinct_chunks``: the first window and that many chunks are
made from the seed in set-up (the chunks then live on the host, as
arriving samples do), and update u sends chunk u mod distinct_chunks. The
state comes from ``sliding_modwt_init`` on the first window, in set-up.
The check rebuilds the stream that was sent and compares every column
read back in the window, and the state's coefficient window after the
window's last update, with the causal MODWT of the stream.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compare import RelErr
from ..reference import sliding as ref
from ..reference import taps

#: updates a block of recorded read-backs holds
RECORD_BLOCK = 4096


class Cell:
    def __init__(self, api, cfg, mix, seed, device, span):
        self.api, self.span = api, span
        self.wavelet, self.level = cfg["wavelet"], cfg["level"]
        self.streams, self.window, self.chunk = mix["streams"], mix["window"], mix["chunk"]
        gen = torch.Generator(device=device).manual_seed(seed)
        dtype = getattr(torch, cfg["dtype"])
        self.x0 = torch.randn((self.streams, self.window), generator=gen, device=device,
                              dtype=dtype)
        pool = torch.randn((mix["distinct_chunks"], self.streams, self.chunk), generator=gen,
                           device=device, dtype=dtype)
        self.pool = [c.numpy() for c in pool.cpu()]
        self.state = api.sliding_modwt_init(self.x0, self.wavelet, self.level)
        self.sent = 0  # updates made so far, warm-up included
        self._cols, self._us, self._fill = [], [], 0  # the window's read-backs

    def call(self, i):
        u = self.sent
        with self.span("update"):
            self.state = self.api.sliding_modwt_update(
                self.state, self.pool[u % len(self.pool)], self.wavelet, self.level)
        self.sent += 1
        return u, self.state

    def result(self, i, out):
        u, state = out
        return u, state.coeffs[..., -self.chunk:].cpu().numpy()

    def record(self, i, res):
        """Copy an update's columns into blocks allocated ahead: a list of
        the read-back arrays themselves keeps a tensor alive each, and the
        collector's sweeps over them grew the window's latency tail."""
        u, cols = res
        if self._fill == RECORD_BLOCK or not self._cols:
            self._cols.append(np.empty((RECORD_BLOCK, *cols.shape), cols.dtype))
            self._us.append(np.empty(RECORD_BLOCK, np.int64))
            self._fill = 0
        self._cols[-1][self._fill] = cols
        self._us[-1][self._fill] = u
        self._fill += 1

    def units(self, i):
        return self.streams * self.chunk

    def kernel_work(self, i):
        return []

    def check(self, kept):
        us = np.concatenate(self._us)[: (len(self._us) - 1) * RECORD_BLOCK + self._fill]
        got = np.concatenate(self._cols)[: len(us)]
        last = int(us.max())
        _, (_, state), _ = max(kept, key=lambda k: k[0])
        pool = torch.from_numpy(np.stack(self.pool)).to(self.x0.device)
        idx = torch.arange(last + 1, device=self.x0.device) % len(self.pool)
        stream = torch.cat([self.x0, pool[idx].permute(1, 0, 2).reshape(self.streams, -1)], -1)
        g, h = taps.modwt_filters(self.wavelet)
        want = ref.causal_modwt(stream, g, h, self.level)  # (S, J+1, T)
        cols = (self.window + self.chunk * torch.from_numpy(us).to(want.device)[:, None]
                + torch.arange(self.chunk, device=want.device))
        got = torch.from_numpy(got).to(want.device)
        expect = want[..., cols].permute(2, 0, 1, 3)  # (U, S, J+1, C), as read back
        diff = torch.nan_to_num((got.double() - expect).abs(), nan=float("inf"))
        per_update = diff.flatten(1).amax(dim=1) / float(expect.abs().max())
        end = self.window + self.chunk * (last + 1)
        window = RelErr().add(state.coeffs, want[..., end - self.window:end])
        return {"new_cols_err": per_update.tolist(), "window_err": [window.value]}
