"""A field of view's rounds already on the card, then its decode: the
FOV's distinct raw rounds, rendered from the seed, stay resident; the
closed loop sends them in turn through ``FovPipeline.process_round``, one
round in flight, each round's spot table copied to the host before the
next starts; after the last round, ``DNAMerfishDecoder.decode`` turns the
FOV's candidate spots into spot groups and homolog traces, whose zxys go
to the host.  A unit is one FOV: its rounds, then its decode.  A round's
latency is its own ``process_round`` to the host; the decode lies inside
the window but in no round."""

from __future__ import annotations

import time

from ..harness import decode_check, held_spots
from ..harness.cell import (RoundDriver, scene_optics, seed_thresholds,
                            set_tf32)
from ..harness.codebook_scene import CodebookScene


class Driver(RoundDriver):

    def __init__(self, ctx):
        super().__init__(ctx)
        c = ctx.config
        self.rounds_per_unit = int(c["rounds_per_fov"])
        #: the last FOV's rounds on the host, in round order, and the
        #: program's decode of them
        self.last_rounds, self.last_decoded = [], None
        self.decoder = None

    def build_pipeline(self):
        from imageanalysis3_tpu_torch.config import config_from_dict
        from imageanalysis3_tpu_torch.decode import DNAMerfishDecoder
        from imageanalysis3_tpu_torch.pipeline import FovPipeline

        c, dev = self.ctx.config, self.ctx.device
        if c["cells_per_fov"] != 1:
            raise ValueError("the scene holds one nucleus a field")
        self.scene = CodebookScene(
            dict(c["scene"], n_chr=c["chromosomes"],
                 n_per_chr=c["loci_per_chromosome"]),
            self.shape, c["n_channels"], self.drift_idx,
            self.rounds_per_unit, self.ctx.seed)
        self.pipe = FovPipeline(
            config_from_dict(dict(c["pipeline"], image_size=list(self.shape))),
            n_channels=c["n_channels"], drift_channel_index=self.drift_idx,
            fit_channel_indices=self.fit_idx, image_shape=self.shape,
            seed_thresholds=seed_thresholds(c), device=dev)
        d = c["decode"]
        self.decoder = DNAMerfishDecoder(
            self.scene.codebook, pixel_sizes=c["pipeline"]["pixel_size_nm"],
            pair_search_radius=d["pair_search_radius_nm"],
            num_homologs=d["num_homologs"], keep_ratio_th=d["keep_ratio_th"],
            device=dev)
        self.region_chr = {int(i): str(ch) for i, ch in zip(
            self.scene.codebook["id"], self.scene.codebook["chr"])}
        self.ctx.mark("pipeline")

    def setup(self) -> None:
        self.build_pipeline()
        dev = self.ctx.device
        self.pool = [self.scene.round_stack(r, dev)
                     for r in range(self.rounds_per_unit)]
        self.ctx.mark("inputs")
        self.ref = self.pipe.prepare_reference(
            self.pipe.correct_reference(self.reference_raw()))
        self.ctx.mark("reference")
        for _ in range(int(self.ctx.spec.traffic["warm_units"])):
            self.unit()
        self.ctx.mark("warm")
        self.outputs.clear()

    def reference_raw(self):
        """Round 0, which the FOV's rounds are registered to."""
        return self.pool[0]

    def bit_of(self, r: int, f: int) -> int:
        return self.scene.bit(r, self.fit_idx[f])

    def unit(self):
        lats = [self.round_on_host(i, raw) for i, raw in enumerate(self.pool)]
        rounds = [out for _, out in self.outputs[-len(self.pool):]]
        spots, bits = decode_check.fov_candidates(rounds, self.bit_of)
        with self.ctx.span("decode"):
            res = self.decoder.decode(spots, bits)
            self.last_decoded = decode_check.program_decoded(
                self.decoder, res, self.region_chr)
        self.last_rounds = rounds
        return lats

    def release(self) -> None:
        self.decoder = None
        super().release()

    # -- the check -----------------------------------------------------------

    def reference_round(self):
        """The plain reference's round that also names the spots whose fit
        the order of their pixels decides (``reference/pixel_order.py``)."""
        from ..reference.pixel_order import OrderedRound

        illum, chrom = scene_optics(self.scene)
        return OrderedRound(self.ctx.config["pipeline"], self.shape,
                            self.drift_idx, self.fit_idx, illum, chrom,
                            seed_thresholds(self.ctx.config),
                            self.ctx.device)

    def reference_output(self, rr, pool_index: int, spectra) -> dict:
        out = super().reference_output(rr, pool_index, spectra)
        out["decided"] = rr.decided.cpu().numpy()
        return out

    def compare_rounds(self, picks, reference):
        """The base numbers, with ``spot_gap_px`` held only on pairs whose
        reference spot the pixel order does not decide; the gap over every
        pair is read as ``paired_gap_px`` and the decided spots' share as
        ``order_decided_share``."""
        numbers = super().compare_rounds(picks, reference)
        gap, decided, n_ref = 0.0, 0, 0
        for idx, prog in picks:
            ref = reference[idx]
            h = held_spots.held_gap(prog["spots"], prog["valid"],
                                    ref["spots"], ref["valid"],
                                    ref["decided"])
            gap = max(gap, h["spot_gap_px"])
            decided += h["decided"]
            n_ref += h["n_ref"]
        numbers["paired_gap_px"] = numbers["spot_gap_px"]
        numbers["spot_gap_px"] = gap
        numbers["order_decided_share"] = decided / max(n_ref, 1)
        return numbers

    def n_cells(self) -> int:
        c = self.ctx.config
        return (c["chromosomes"] * c["loci_per_chromosome"]
                * c["scene"]["n_homologs"])

    def _decode(self, rounds):
        return decode_check.decode_rounds(rounds, self.bit_of,
                                          self.scene.codebook,
                                          self.ctx.config, self.ctx.device)

    def check(self):
        """The rounds' numbers on `check_rounds` rounds of the window, and
        the decode's: the reference's decode of the last FOV's program
        spot tables against the program's decode of them."""
        numbers = super().check()
        set_tf32(self.torch, False)
        numbers.update(decode_check.compare(
            self.last_decoded, self._decode(self.last_rounds),
            self.n_cells()))
        return numbers

    def control(self):
        """The rounds' numbers with the reference in TF32 in the program's
        place; the decode's: the last FOV's tables with the checked
        rounds' tables from the reference in TF32, decoded by the
        reference, against the same with them from the reference in
        float32."""
        picks = self.picks()
        low = self.reference_outputs(picks, tf32=True)
        high = self.reference_outputs(picks)
        numbers = self.compare_rounds([(i, low[i]) for i, _ in picks], high)

        def with_(outs):
            return [dict(outs[i]) if i in outs else out
                    for i, out in enumerate(self.last_rounds)]

        set_tf32(self.torch, True)
        try:
            low_dec = self._decode(with_(low))
        finally:
            set_tf32(self.torch, False)
        numbers.update(decode_check.compare(
            low_dec, self._decode(with_(high)), self.n_cells()))
        return numbers

    def split(self, n: int = 3):
        """The base split, and the decode of the last FOV timed apart."""
        out = super().split(n)
        spots, bits = decode_check.fov_candidates(self.last_rounds,
                                                  self.bit_of)
        self.ctx.sync()
        t0 = time.perf_counter()
        self.decoder.decode(spots, bits)
        out["decode"] = [time.perf_counter() - t0]
        return out
