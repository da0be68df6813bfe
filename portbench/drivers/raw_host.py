"""Rounds that arrive from host memory: a pool of raw interleaved frame
windows (the layout ``io.dax.read_raw_window`` returns and
``FovPrefetcher``'s pinned ring holds) in page-locked host memory, sent in
turn through ``FovPipeline.process_round_raw`` in a closed loop, each
round's spot table copied to the host before the next starts.  A unit is
one round."""

from __future__ import annotations

import time

from ..harness.cell import RoundDriver, host_round
from ..harness.scene import interleave_window


class Driver(RoundDriver):

    def setup(self) -> None:
        torch = self.torch
        self.build_pipeline()
        dev, n = self.ctx.device, int(self.ctx.spec.traffic["pool_rounds"])
        buffer = int(self.ctx.spec.traffic["buffer_frames"])
        self.host = []
        for r in range(n):
            win, self.rel_starts = interleave_window(
                self.scene.round_stack(r, dev), buffer)
            pinned = torch.empty(win.shape, dtype=win.dtype,
                                 pin_memory=dev.type == "cuda")
            pinned.copy_(win)
            self.host.append(pinned)
            del win
        self.ctx.mark("inputs")
        self.n_colors = self.ctx.config["n_channels"]
        self.pool = self.host
        self.ref = self.pipe.prepare_reference(
            self.pipe.correct_reference(self.reference_raw()))
        self.ctx.mark("reference")
        self.k = 0
        for _ in range(int(self.ctx.spec.traffic["warm_units"])):
            self.unit()
        self.ctx.mark("warm")
        self.outputs.clear()
        self.k = 0

    def reference_raw(self):
        return self.scene.round_stack(-1, self.ctx.device)

    def device_round(self, pool_index: int):
        from ..reference.corrections import deinterleave_stack

        return deinterleave_stack(self.host[pool_index].to(self.ctx.device),
                                  self.rel_starts, self.n_colors,
                                  self.shape[0])

    def unit(self):
        i = self.k % len(self.host)
        self.k += 1
        t0 = time.perf_counter()
        with self.ctx.span("process_round_raw"):
            res = self.pipe.process_round_raw(self.host[i], self.ref,
                                              self.rel_starts, self.n_colors)
        with self.ctx.span("to_host"):
            out = host_round(res)
        lat = time.perf_counter() - t0
        self.outputs.append((i, out))
        return [lat]

    def reference_output(self, rr, pool_index: int, spectra) -> dict:
        o = rr.run_raw_window(self.host[pool_index], spectra, self.rel_starts,
                              self.n_colors)
        return {"spots": o.spots.cpu().numpy(), "valid": o.valid.cpu().numpy(),
                "drift": o.drift.cpu().numpy(), "flag": o.flag}
