"""What every traffic driver shares: the scene and the program under test
built from the configuration, a round's result brought to the host, the
layers timed apart, and the comparison with the plain reference.

A driver (``drivers/<name>.py``) subclasses :class:`RoundDriver` and
writes ``setup`` (inputs on their side of the bus, the program built and
warmed) and ``unit`` (one closed-loop unit of the window, returning the
latency of each round it carried to the output).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import compare
from .scene import PlantedScene, rng_of


def set_tf32(torch, on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)


class Context:
    """The run as a driver sees it."""

    def __init__(self, spec, seed: int, device, torch, tracing: bool,
                 t0: Optional[float] = None):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.torch, self.tracing = torch, bool(tracing)
        self.config = spec.config
        #: set-up seconds by phase, for an earlier line of the output
        self.phases: Dict[str, float] = {}
        self._last = time.perf_counter()
        if t0 is not None:
            # imports, the CUDA context and the kernels' build
            self.phases["start"] = self._last - t0

    def mark(self, phase: str) -> None:
        """Close a set-up phase (after a synchronisation)."""
        self.sync()
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now

    def span(self, name: str):
        """A profiler range named ``portbench.<name>`` in a traced run."""
        if not self.tracing:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function("portbench." + name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def make_scene(ctx: Context):
    c = ctx.config
    kind = c["scene"]["kind"]
    if kind == "planted":
        return PlantedScene(c["scene"], c["shape"], c["n_channels"],
                            c["drift_channel"], ctx.seed)
    raise ValueError(f"unknown scene kind {kind!r}")


def scene_optics(scene) -> Tuple[np.ndarray, np.ndarray]:
    """(illumination (C, X, Y), chromatic constants (C, 3, 10)) that the
    deployment's profiles give the pipeline."""
    return scene.illumination(), scene.chromatic


def seed_thresholds(config: dict) -> np.ndarray:
    """Each channel's seeding threshold: the configuration's ``seed_th`` by
    channel name, else the pipeline's ``th_seed``."""
    by_name = config.get("seed_th", {})
    default = config["pipeline"]["seed"]["th_seed"]
    return np.array([by_name.get(ch, default) for ch in config["channels"]],
                    np.float32)


def host_round(res) -> dict:
    """A RoundResult's spot table on the host."""
    return {"spots": res.spots.cpu().numpy(), "valid": res.valid.cpu().numpy(),
            "drift": res.drift.cpu().numpy(), "flag": int(res.drift_flag)}


class RoundDriver:
    """Base of the drivers: the program's pipeline over one scene."""

    #: rounds one unit of the window carries to its output
    rounds_per_unit = 1

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.torch = ctx.torch
        c = ctx.config
        self.shape = tuple(c["shape"])
        self.drift_idx = int(c["drift_channel"])
        self.fit_idx = tuple(int(i) for i in c["fit_channels"])
        self.failed_rounds = 0
        #: (index of the raw input in the pool, its round on the host) of
        #: every round of the window, in order
        self.outputs: List[Tuple[int, dict]] = []

    # -- the program ------------------------------------------------------

    def build_pipeline(self):
        from imageanalysis3_tpu_torch.config import config_from_dict
        from imageanalysis3_tpu_torch.pipeline import FovPipeline

        c = self.ctx.config
        self.scene = make_scene(self.ctx)
        illum, chrom = scene_optics(self.scene)
        self.pipe = FovPipeline(
            config_from_dict(dict(c["pipeline"], image_size=list(self.shape))),
            n_channels=c["n_channels"], drift_channel_index=self.drift_idx,
            fit_channel_indices=self.fit_idx, illumination=illum,
            chromatic_constants=chrom, image_shape=self.shape,
            seed_thresholds=seed_thresholds(c), device=self.ctx.device)
        self.ctx.mark("pipeline")

    def round_on_host(self, pool_index: int, raw) -> float:
        """One round through ``process_round``, its spot table to the host;
        returns the round's latency."""
        t0 = time.perf_counter()
        with self.ctx.span("process_round"):
            res = self.pipe.process_round(raw, self.ref)
        with self.ctx.span("to_host"):
            out = host_round(res)
        lat = time.perf_counter() - t0
        self.outputs.append((pool_index, out))
        return lat

    def device_round(self, pool_index: int):
        """The raw (C, Z, X, Y) stack of a pool round on the device."""
        return self.pool[pool_index]

    def split(self, n: int = 3) -> Dict[str, List[float]]:
        """Each layer timed apart on n pool rounds, on the host clock
        around work that ends in a synchronisation: the corrections of all
        channels of a round, its drift, and each data channel's seeding
        and fit."""
        pipe, sync = self.pipe, self.ctx.sync
        out = {"correct": [], "drift": [], "fit": []}

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            r = fn()
            sync()
            return r, time.perf_counter() - t0

        for i in range(min(n, len(self.pool))):
            raw = self.device_round(i)
            corr, t = timed(lambda: [pipe.correct_one(raw[ci], ci)
                                     for ci in range(raw.shape[0])])
            out["correct"].append(t)
            out["drift"].append(timed(lambda: pipe.drift_of(
                corr[self.drift_idx], self.ref))[1])
            for ci in self.fit_idx:
                out["fit"].append(timed(lambda: pipe.fit_channel(
                    corr[ci], float(pipe.seed_thresholds[ci])))[1])
            del corr, raw
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None
        self.ref = None
        if self.ctx.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference_round(self):
        from ..reference.round import ReferenceRound

        illum, chrom = scene_optics(self.scene)
        return ReferenceRound(self.ctx.config["pipeline"], self.shape,
                              self.drift_idx, self.fit_idx, illum, chrom,
                              seed_thresholds(self.ctx.config),
                              self.ctx.device)

    def reference_output(self, rr, pool_index: int, spectra) -> dict:
        """The plain reference's round for a pool input."""
        o = rr.run(self.device_round(pool_index), spectra)
        return {"spots": o.spots.cpu().numpy(), "valid": o.valid.cpu().numpy(),
                "drift": o.drift.cpu().numpy(), "flag": o.flag}

    def picks(self) -> List[Tuple[int, dict]]:
        """The window's rounds the reference checks: `check_rounds` of
        them, drawn from the seed."""
        k = min(int(self.ctx.spec.checks["check_rounds"]), len(self.outputs))
        at = rng_of(self.ctx.seed, 90).choice(len(self.outputs), k,
                                              replace=False)
        return [self.outputs[i] for i in sorted(at)]

    def compare_rounds(self, picks, reference: Dict[int, dict]
                       ) -> Dict[str, float]:
        drift_gap, unpaired, moved, n_ref = 0.0, 0, 0, 0
        spot_gap, height_gap = 0.0, 0.0
        for idx, prog in picks:
            ref = reference[idx]
            gap = float(np.abs(prog["drift"] - ref["drift"]).max())
            drift_gap = max(drift_gap, gap if prog["flag"] == ref["flag"]
                            else float("inf"))
            s = compare.spot_tables(prog["spots"], prog["valid"],
                                    ref["spots"], ref["valid"])
            unpaired += s["unpaired"]
            moved += s["moved"]
            n_ref += s["n_ref"]
            spot_gap = max(spot_gap, s["spot_gap_px"])
            height_gap = max(height_gap, s["height_gap"])
        return {"drift_gap_px": drift_gap,
                "moved_share": moved / max(n_ref, 1),
                "spot_gap_px": spot_gap,
                "unpaired_share": unpaired / max(n_ref, 1),
                "height_gap": height_gap}

    def reference_outputs(self, picks, tf32: bool = False) -> Dict[int, dict]:
        """The reference's rounds for the picked inputs, in float32 (TF32
        off) or, for the control, in TF32."""
        torch = self.torch
        set_tf32(torch, tf32)
        try:
            rr = self.reference_round()
            spectra = rr.spectra(self.reference_raw())
            out = {}
            for idx in sorted({i for i, _ in picks}):
                out[idx] = self.reference_output(rr, idx, spectra)
            return out
        finally:
            set_tf32(torch, False)

    def check(self) -> Dict[str, float]:
        """The numbers compared, the program against the reference."""
        picks = self.picks()
        return self.compare_rounds(picks, self.reference_outputs(picks))

    def control(self) -> Dict[str, float]:
        """The same numbers with the reference in TF32 in the program's
        place, against the reference in float32."""
        picks = self.picks()
        low = self.reference_outputs(picks, tf32=True)
        return self.compare_rounds([(i, low[i]) for i, _ in picks],
                                   self.reference_outputs(picks))
