"""Rounds already on the card, one in flight: a pool of distinct raw
rounds rendered from the seed stays resident, and the closed loop sends
the pool's rounds in turn through ``FovPipeline.process_round``, each
round's spot table copied to the host before the next starts.  A unit is
one round."""

from __future__ import annotations

from ..harness.cell import RoundDriver


class Driver(RoundDriver):

    def setup(self) -> None:
        self.build_pipeline()
        dev, n = self.ctx.device, int(self.ctx.spec.traffic["pool_rounds"])
        self.pool = [self.scene.round_stack(r, dev) for r in range(n)]
        self.ctx.mark("inputs")
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

    def unit(self):
        i = self.k % len(self.pool)
        self.k += 1
        return [self.round_on_host(i, self.pool[i])]
