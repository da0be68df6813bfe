#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100)::

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on a failed check:

1. setup: card name and power limit, versions, TF32 off, build the six
   CUDA kernels from ``imageanalysis3_tpu_torch/csrc`` (one nvcc per
   source, started together);
2. kernels: each kernel against its plain PyTorch version on the rendered
   60x2048x2048 bench scene (the pyramid classifier, held equal to its
   plain version there, on a ragged 12x196x260 stack and through its
   run-time-radius code, with its registers, shared memory and resident
   warps; the exact classifier, whose default taps run the bg blur on the
   tensor cores and are held by tolerance, with the one-warp proof of its
   mma fragment layout, two equal
   launches, a constant stack and a full-range input; the level stencil,
   held equal to its plain version (level, counts and diff) at 60 and 30
   planes, on ragged and unaligned crops (its 4-byte-copy instance), at
   nz = 1, 2, 3, on tie plateaus, a constant and a full-range stack and
   at n_lvl 1 and 126, timed at both shapes with its occupancy and waves;
   the dual x+y blur, whose default taps also run the bg blur on the
   tensor cores (fg bit-identical, bg within the JAX tests' tolerance; a
   7x75x203 stack, a full-range input, two equal launches, a constant
   stack that counts nothing in the 5^3 stencil; timed at 60x2048x2048 and
   30x2048x2048); the exact kernels also through their
   bit-identical run-time-radius code on a small stack; the LM fit on round 0's 2048
   spots x 512 pixels x 8 iterations and on a Jacobi refit round's 512
   warm-started spots, then at every launch shape the paths make (slice 1,
   e2e and calibration rounds 0 and refits, P = 254 and 922; seeds at the
   planted centres), with its registers and resident warps; the gather's
   two entries, each equal to its plain version exactly: cubes at 2048
   seeds with r = 5 and r = 4, on a thin stack and with origins far
   outside the stack, and the fit's in-ball pixels at every launch shape
   the paths make, on the thin stack and far outside; then
   ``gather_blocks`` whole, which must launch one gather and make no cube
   array), with CUDA-event timings of
   kernel and plain version over fresh inputs (and of the gather's one
   advanced-indexing PyTorch call);
3. slice 1's main path: ``FovPipeline.process_round`` at bench.py's
   configuration (pyramid classifier, 1800 planted spots, th_seed 300,
   2048 seed capacity), one warm round and 4 timed rounds; seed_pyramid,
   lm_fit and gather_cubes must launch in every round, and every round's
   fitted centres must meet bench.py's accuracy gate
   (median_centroid_err_px <= 0.02 over the first 500 truths);
4. the dual-blur path (``SeedConfig(pyramid_bg=False, filt_size=5)`` on a
   30x2048x2048 stack, 2 timed rounds under the same gate; dual_blur,
   lm_fit and gather_cubes must launch in each) and the level-stencil path
   (``dual_gaussian_blur`` then ``level_stencil`` on one corrected stack,
   held against the plain stencil on the same blurs);
5. the end-to-end path of bench_e2e.py with the exact classifier: 20
   rounds of 3-channel 60x2048x2048 stacks rendered on the card, seeded by
   seed_classify on every data channel, fitted, then decoded by
   ``DNAMerfishDecoder`` into 300 homolog region traces; >= 285 regions
   assigned, median trace error <= 1.25x the planted-jitter floor, median
   drift error <= 0.1 px; the decode's spans under the timing record
   (event intervals, candidates, groups, waits on the card), its outputs
   equal with the record on; then the summation order's gate
   (``--only lm_order``): each data channel of the scene's first 3
   rounds, seeded by the path, its round-0 and refit LM batches under
   ``_check_lm`` with a spot decided by the order when another order of
   its pixels moves its plain fit beyond 5e-4 px (at most 0.5 %), every
   other spot held to 1e-3 px;
6. the bead-calibration path on ``synthetic.make_calibration_scene``'s
   60x2048x2048 stacks: (a) ``IlluminationProfiler`` over 4 flat-field
   stacks (interior error < 0.05); (b) ``generate_bleed_profile_from_rounds``
   on 3 single-label rounds (the leak into a neighbouring channel < 0.25x
   after unmixing); (c) ``generate_chromatic_constants`` on two bead pairs
   (n_pairs >= 50 % of the beads, corrected beads within a median 0.1 px);
   (d) the profiles saved and loaded as files, a ``FovPipeline`` built from
   them, one 3-channel round under all three optics (median error <= 0.1
   px per channel); seed_classify, lm_fit and gather_cubes must launch
   where the path calls them, and none in (a);
7. the on-disk .dax path at bench.py's geometry: two 3-channel rounds of
   60x2048x2048 (1800 spots in each of 750 and 647 under a vignette, 750
   also under order-2 chromatic shifts; 500 beads in 488; the second
   round drifted by (0.6, -1.4, 2.3) px) written as interleaved .dax
   movies, read back bit for bit by the native loader, ``read_dax`` +
   ``split_channels`` and ``read_raw_window`` + ``deinterleave_stack``;
   ``warp_image`` against the 8-tap gather at full size; ``DaxProcesser``
   (load, hot pixels, illumination, ``align_image`` drift within 0.1 px,
   fits on the coordinate path (median <= 0.05 px) and after the
   chromatic + drift image warp (<= 0.1 px), >= 90 % matched);
   ``FovPipeline.process_round_raw`` and ``process_rounds`` equal to
   ``process_round``; seed_classify, seed_pyramid, lm_fit and gather_cubes
   must launch; reads, writes and every step timed;
8. a written experiment through ``ExperimentDriver`` at bench.py's
   geometry: 4 hyb rounds of 3-channel 60x2048x2048 .dax movies (~6.7 GB)
   and a Color_Usage.csv, 8 unique regions of 1800 spots (750 and 647,
   vignetted, 750 also under the order-2 chromatic shifts; 500 beads in
   488), H1..H3 drifted by planted sub-pixel drifts, the profiles in a
   correction folder: ``process_all`` into the per-FOV store (drifts
   within 0.1 px, >= 90 % matched at a median <= 0.05 px per region;
   seed_pyramid, lm_fit and gather_cubes in every round), the resume no-op
   (store byte-identical) and a partial resume (rows equal), the
   device-deinterleave mode (an equal store), sequential drift, the
   chromosome image, candidates and their screening, and region crops
   (H0's equal to the loader's window over the profile); then
   ``FieldOfView`` over the same store (a resume no-op; EM picks on the 8
   x ~1800 candidate table without a centre and at each chromosome
   centre, equal to the CPU's up to f32 ties; the naive pick; the
   distance map within 1e-3 relative of a float64 pdist); every step
   timed;
9. picking at a lab's width, no kernel: ``em_pick_spots_exclusive`` on 8
   planted cells of two homologs (300 regions x 16 candidates each),
   shared-spot EM, ``check_picked_spots``, ``merge_spot_lists`` on two
   passes' lists, ``em_pick_spots_in_population`` on 2048 chromosomes x
   300 regions x up to 8 candidates, the median and contact maps of its
   picks, and ``tuple_self_scores`` against ``collect_invalid_pairs`` on
   phase 5's decoded groups; planted recovery >= 0.9, exclusivity, picks
   equal to the CPU's up to f32 ties, the median map within 1e-3 of
   NumPy's float64 ``nanmedian``;
10. the per-cell spot path at a lab's width: an 8x8 grid of segmented
   nuclei in one 60x2048x2048 channel (20 dim spots each, 400 bright ones
   outside), written as a .dax movie;
   ``DaxProcesser._fit_spots_by_segmentation`` (seed_classify, lm_fit and
   gather_cubes on every nucleus crop; >= 90 %
   of planted spots in their cell at a median <= 0.05 px, every kept spot
   within segment_search_radius of its mask, 4 cells equal to the port's
   CPU run), the three kernels against their plain versions at the crop
   shapes; the kept spots as a column table through the .npy files bit
   for bit, ``spots_to_labels``, ``count_genes``, ``reconstruct_spot_image``
   at full size against its one-spot-at-a-time version; 8 planted cells of
   chromosomes 1, 2 and X through ``SpotMapper``, ``SpotPicker`` (recovery
   >= 0.9 per homolog, 2 cells equal to the CPU's), ``batch_pick_spots`` on
   a .npy decoded file, ``load_picked`` and ``interpolate_chr``;
11. polymer post-analysis and the rest of ops/ (_analysis_phase): a
   population of 2048 chromosomes x 300 regions of planted domain globules
   through the compartment, domain, bootstrap and interaction functions; a
   genome-wide scene of chromosomes 1-22 and X (~1000 loci, 500 cells)
   through the summaries, the matrix, the interaction groups (planted
   3-chromosome hubs) and the density clouds; phase 10's nuclei through
   the cell-location tables; slice 1's bench stack through
   ``fit_matched_centers`` and the legacy fit adapters (seed_classify,
   lm_fit and gather_cubes counted per entry); each against the port's CPU
   run on a subset;
12. segmentation (_segmentation_phase): a 60x2048x2048 DAPI channel of
   phase 10's grid of nuclei, four positions holding a touching pair, each
   nucleus with its own brightness, gradient and speckle, and a polyT
   channel with a 1.5x halo: ``segment_nuclei``, ``screen_labels`` and
   ``split_oversized_nuclei`` (one label a nucleus, single nuclei at IoU >=
   0.85, each pair in two; a 60x256x256 crop equal to the CPU's); those
   labels through ``DaxProcesser._fit_spots_by_segmentation`` on spots
   planted in the same nuclei (seed_classify, lm_fit and gather_cubes;
   >= 90 % in their own cell at a median <= 0.05 px); ``segment_cells``
   (each cell holds its nucleus and ends in its halo); the 3D UNet at full
   width trained 200 steps on one pooled crop, then
   ``segment_fov_learned`` over the FOV (>= 90 % of nuclei at IoU >= 0.6,
   ``unet_apply`` equal to the CPU's at atol 1e-4); cellpose's CPnet at
   its 'nuclei' geometry with seeded random weights through
   ``cellpose_flows_3d`` and ``segment_cells_cellpose`` (each view timed,
   the f32 rate of its convolutions, one slice equal to the CPU's);
13. ``parallel/`` under a world-size-1 NCCL group that the phase makes and
   destroys (_parallel_phase): ``process_rounds(mesh=make_mesh(1))`` over
   2 rounds of bench.py's scene in 3 channels, equal to ``process_round``
   per round on every field with the same launches (seed_pyramid, lm_fit
   and gather_cubes in every round) and bench.py's gate; the spatially
   sharded round ``sharded_process_round`` on one drifted 60x2048x2048
   round (drift within 0.1 px, >= 90 % matched, bench.py's gate on its
   fitted centres, lm_fit launched) and ``sharded_correct_and_seed``'s
   seeds equal to ``get_seeds`` on the plain route; ``FovPrefetcher``
   (pinned ring) + ``prefetch_to_device`` over 3 cold .dax movies of phase
   7's layout, bytes equal to the loader's, s/file and the upload GB/s
   pinned and pageable beside PR 10's reading;
14. ``library/`` on the host, no kernel (_library_phase): the native
   seqint built with g++, its word-17 k-mers and a dense word-12 count
   table of a 10 Mb seeded sequence equal to the NumPy path's,
   ``ProbeDesigner`` on 4 regions timed;
15. the legacy facade (_legacy_phase): one FOV of 2 hyb rounds of
   3-channel 60x2048x2048 .dax movies (~3.4 GB), every other row of phase
   10's 8x8 grid of nuclei (32) as its segmentation, two chromosome
   centres a nucleus and one
   spot a region within 2 px of each, through ``CellList(...,
   save_images=True)``: ``_process_fovs`` (flags 2, drift within 0.1 px),
   32 cells, their segmentation and drift, the jittered centres, the
   per-FOV multi-fit (seed_classify, gather_cubes and lm_fit launched; 4
   cells equal to the CPU's at the fit tolerances), EM picks (>= 90 %
   within 1 px at a median <= 0.05 px in H0's frame), the population map
   (1e-3 of NumPy's float64 nanmedian), domains, ternary dependent maps
   (their pools exactly the flagged chromosomes) and the cell checkpoints
   reloaded equal;
16. ``figures/`` (_figures_phase), only where matplotlib imports (else it
   says why): ``SpotBrowser`` over slice 1's corrected bench stack zoomed
   to 60x256x256 (``seed_view``: one seed_classify launch, seeds equal to
   the CPU's up to hazard 6; ``fit_view``: gather_cubes and lm_fit, >= 90
   % of the view's planted spots within 1 px at a median <= 0.05 px),
   ``BoundaryMarker`` on a 300-region population map, and every plot and
   3D render once at a lab's size, each PNG > 1000 bytes;
17. the span record (_tracing_phase), on 3-channel 30x2048x2048 rounds
   of bench.py's spots: spans on the profiler's clock, each round's count
   of its waits on the card equal to what
   ``torch.cuda.set_sync_debug_mode("warn")`` reports, none outside a
   sync span and none at a site other than ``refit_check``,
   ``drift_flag`` or ``upload``, no device constant built after the
   warm-up round (``const_builds``), outputs and device ops the same with
   it on and off, its cost, and its rounds without the profiler and under
   it.

The script's whole time, then the last three lines: a JSON object
describing each kernel, the card's name and power limit, and ``{"ok":
true, "device": {...}}``.  A fuller
record goes to ``chiprun_out/chip_smoke.json``.  ``--profile`` adds one
slice-1 round under torch.profiler (device time by kernel, device busy
share).  ``--only seed_classify``, ``--only seed_pyramid``, ``--only
lm_fit``, ``--only dual_blur``, ``--only level_stencil`` and ``--only
gather_cubes`` build that kernel alone and run its checks and timing,
nothing else (``--only level_stencil`` also runs from an older tree, which
then reports no occupancy); ``--only gather_blocks`` times
``gaussian_fit.gather_blocks`` whole at every launch shape and checks
nothing (so that it also times an older tree's); ``--only dax_path`` builds
the four kernels of phase 7 and runs that phase alone; ``--only
experiment`` builds the three kernels of phase 8 and runs that phase alone;
``--only picking`` runs phase 9 alone (no kernel; its self-scores then run
on planted groups); ``--only cell_spots`` builds the per-cell path's three
kernels and runs phase 10 alone; ``--only analysis`` builds seed_classify,
lm_fit and gather_cubes and runs phase 11 alone; ``--only segmentation``
builds the same three and runs phase 12 alone; ``--only parallel`` builds
slice 1's three kernels and runs phase 13 alone, ``--only library`` phase
14 alone (no kernel); ``--only parallel_ranks`` (four cards, not part of
the one-card run) builds lm_fit and runs phase 13 (b)'s sharded round
across four cards, one spawned process each under NCCL, against the same
program on one card; ``--only legacy`` and ``--only figures`` build
seed_classify, lm_fit and gather_cubes and run phase 15 or 16 alone;
``--only tracing`` builds slice 1's three kernels and runs phase 17 alone
(the span record), its record as a JSON line last.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# bench.py's scene
SHAPE = (60, 2048, 2048)
N_SPOTS = 1800
ROUNDS = 4
TH_SEED = 300.0
N_LVL = 10
EDGE = 2
#: kernels of slice 1's main path (pyramid classifier)
PYRAMID_PATH = ("seed_pyramid", "lm_fit", "gather_cubes")
#: the dual-blur path's stack: the package's DEFAULT_IMAGE_SIZE
DUAL_SHAPE = (30, 2048, 2048)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _function_name(mangled: str) -> str:
    """The kernel's own identifier in an Itanium-mangled name (the one whose
    length prefix spans it and that ends in kernel, selftest or rate), with
    a template radius as <R> and a template flag as <true> or <false>."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):
            start, n = m.end(), int(digits[k:])
            ident = mangled[start:start + n]
            if re.fullmatch(r"[A-Za-z_]\w*(kernel|selftest|rate)", ident):
                found.append((n, start))
    if not found:
        return mangled
    # the shortest: an anonymous namespace's name may end where it starts
    n, start = min(found)
    ident = mangled[start:start + n]
    t = re.match(r"IL([ib])(\d+)E", mangled[start + n:])
    if not t:
        return ident
    arg = t.group(2)
    if t.group(1) == "b":
        arg = "true" if arg == "1" else "false"
    return ident + f"<{arg}>"


def _ptxas_report(log: str):
    """One line per function from ``nvcc -Xptxas -v`` output: its name,
    registers, stack and spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = _function_name(line.split("for", 1)[1].strip())
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def _peaks(name: str):
    """(bytes/s, f32 flop/s) published for this H100 part (NVIDIA data
    sheets; dense f32 outside the tensor cores)."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12, "H100 PCIe: 2.0 TB/s, 51.2 TFLOP/s f32"
    if "NVL" in name:
        return 3.9e12, 60.0e12, "H100 NVL: 3.9 TB/s, 60 TFLOP/s f32"
    return 3.35e12, 67.0e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s f32"


def _bound(nbytes: float, nops: float, peaks):
    bw, fl, _ = peaks
    t_b, t_o = nbytes / bw * 1e3, nops / fl * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _events_ms(torch, fn, inputs, queue_ahead: bool):
    """Median CUDA-event time of fn(*inp) over fresh inputs (after one
    warm-up call).  With `queue_ahead` the launches are enqueued behind a
    device sleep so host launch overhead cannot open gaps between them."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(inputs) + 1)]
    if queue_ahead and hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i, inp in enumerate(inputs):
        fn(*inp)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(len(inputs)))


def _check_accuracy(label, res, centers):
    """bench.py's gate on channel 0 of a RoundResult: median centroid error
    over the first 500 truths matched within 1 px <= 0.02 px, and n_valid
    >= 90% of the planted spots."""
    need_valid = int(np.ceil(0.9 * len(centers)))
    got = res.spots[0][res.valid[0]][:, 1:4].cpu().numpy()
    errs = []
    for c in centers[:500]:
        d = np.linalg.norm(got - c, axis=1).min() if len(got) else np.inf
        if d < 1.0:
            errs.append(d)
    med = float(np.median(errs)) if errs else float("nan")
    n_val = int(res.valid[0].sum())
    print(f"accuracy {label}: median_centroid_err_px {med:.5f} over "
          f"{len(errs)} matched truths, n_valid {n_val}, drift "
          f"{res.drift.cpu().numpy().round(4).tolist()} flag "
          f"{int(res.drift_flag)}")
    if not med <= 0.02:
        raise AssertionError(f"{label}: median_centroid_err_px {med} > 0.02")
    if n_val < need_valid:
        raise AssertionError(f"{label}: n_valid {n_val} < {need_valid}")
    return med, n_val


def _max_abs(torch, a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _check_seed_classify(torch, sk, inp) -> dict:
    """seed_classify against its plain version on one input: qualification
    agrees on > 1 - 1e-5 of voxels, qdiff within rtol 1e-4 / atol 0.05
    where both qualify, counts within 2."""
    qk, ck = sk.fused_seed_classify_cuda(*inp)
    qp, cp = sk.fused_seed_classify_plain(*inp)
    torch.cuda.synchronize()
    fk, fp = torch.isfinite(qk), torch.isfinite(qp)
    agree = float((fk == fp).double().mean())
    if not agree > 1 - 1e-5:
        raise AssertionError(f"seed_classify: qualification agrees on "
                             f"{agree} of voxels")
    both = fk & fp
    if not torch.allclose(qk[both], qp[both], rtol=1e-4, atol=0.05):
        raise AssertionError("seed_classify: qdiff differs beyond rtol 1e-4 "
                             "/ atol 0.05")
    dcount = abs(int(ck.sum()) - int(cp.sum()))
    if dcount > 2:
        raise AssertionError(f"seed_classify: counts differ by {dcount}")
    return {"max_abs_err": _max_abs(torch, qk[both], qp[both]),
            "agree": agree, "n_disagree": int((fk != fp).sum()),
            "n_qual": int(fp.sum()),
            "counts": (int(ck.sum()), int(cp.sum())),
            "identical": torch.equal(qk, qp) and torch.equal(ck, cp)}


def _seed_classify_checks(torch, sk, corrected, k_fg, k_bg, peaks,
                          smi: str) -> dict:
    """Everything held of seed_classify, on the corrected 60x2048x2048
    stacks: (1) the one-warp proof of the mma fragment layout, a 16x8 by 8x8
    product against the host's float64 one within 2e-6 of sum |a||b|; (2)
    the default taps (bg passes on the tensor cores) against the plain
    version within _check_seed_classify's tolerances, and the run-time-radius
    code (fg sigma 1.5 / bg sigma 5 on a small stack), which must stay
    bit-identical, and the default taps on a 7x75x203 stack (narrower than
    the bg window, a width that is no multiple of 4); (2b) the rate the card sustains for the kernel's mma
    instruction alone, for reading its time; (3) two launches on one input give equal outputs; (4) a
    constant 12x256x256 stack counts nothing in any level; (5) the same
    tolerances on a full-range input (stack and threshold scaled so that
    the stack reaches 65 535);
    then CUDA-event medians of kernel and plain version over the fresh
    inputs and the bound."""
    from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d

    dev = corrected[0].device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(11)
    a = (torch.randn(16, 8, generator=gen) * 1000.0).to(dev)
    b = torch.randn(8, 8, generator=gen).to(dev)
    d = sk.mma_selftest_cuda(a, b)
    torch.cuda.synchronize()
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    mma_err = float(((d.double() - want).abs() / scale).max())
    if not mma_err <= 2e-6:
        raise AssertionError(f"seed_classify: mma fragment layout: error "
                             f"{mma_err} of sum |a||b|")

    n_mma, mma_ms = sk.mma_rate_cuda(dev)
    mma_tflops = n_mma * 2 * 16 * 8 * 8 / mma_ms / 1e9

    zpass = [sk.z_pass_pair(im, k_fg, k_bg) for im in corrected]
    cls_in = [(fgz, bgz, k_fg, k_bg, TH_SEED, N_LVL, EDGE)
              for fgz, bgz in zpass]
    cls = _check_seed_classify(torch, sk, cls_in[0])
    k_fg2, k_bg2 = gaussian_kernel1d(1.5), gaussian_kernel1d(5.0)
    zs = sk.z_pass_pair(corrected[0][:12, :256, :256].contiguous(),
                        k_fg2, k_bg2)
    cls_gen = _check_seed_classify(
        torch, sk, (*zs, k_fg2, k_bg2, TH_SEED, N_LVL, EDGE))
    if not cls_gen["identical"]:
        raise AssertionError("seed_classify: the run-time-radius path "
                             "differs from its plain version")

    # a stack narrower than the bg window and of a width that is no
    # multiple of 4: every block reflects and copies unaligned
    odd = corrected[0][20:27, 300:375, 500:703].contiguous()
    cls_odd = _check_seed_classify(
        torch, sk, (*sk.z_pass_pair(odd, k_fg, k_bg), k_fg, k_bg, TH_SEED,
                    N_LVL, EDGE))

    q1, c1 = sk.fused_seed_classify_cuda(*cls_in[1])
    q2, c2 = sk.fused_seed_classify_cuda(*cls_in[1])
    torch.cuda.synchronize()
    if not (torch.equal(q1, q2) and torch.equal(c1, c2)):
        raise AssertionError("seed_classify: two launches on one input "
                             "differ")
    del q1, q2

    flat = torch.full((12, 256, 256), 800.0, device=dev)
    qf, cf = sk.fused_seed_classify_cuda(*sk.z_pass_pair(flat, k_fg, k_bg),
                                         k_fg, k_bg, TH_SEED, N_LVL, EDGE)
    torch.cuda.synchronize()
    if int(cf.sum()) != 0:
        raise AssertionError(f"seed_classify: a constant stack counted "
                             f"{cf.tolist()}")
    flat_qualified = int(torch.isfinite(qf).sum())

    # the threshold scales with the data, so the same voxels are in play
    # and only the magnitudes, and with them the absolute errors, grow
    gain = 65535.0 / float(corrected[0].max())
    full = corrected[0] * gain
    cls_full = _check_seed_classify(
        torch, sk, (*sk.z_pass_pair(full, k_fg, k_bg), k_fg, k_bg,
                    TH_SEED * gain, N_LVL, EDGE))
    del full

    ms = _events_ms(torch, sk.fused_seed_classify_cuda, cls_in,
                    queue_ahead=True)
    plain_ms = _events_ms(torch, sk.fused_seed_classify_plain, cls_in,
                          queue_ahead=False)
    nvox = float(corrected[0].numel())
    kb, kf = len(k_bg), len(k_fg)
    nbytes = 4 * nvox * 3 + 4 * N_LVL
    # x and y passes of both stacks (k products, k-1 sums each), 26 maxima
    # and 26 minima, the difference and two compares; 4 more per
    # qualifying voxel for its level
    bound = _bound(nbytes,
                   nvox * (2 * (2 * kf - 1) + 2 * (2 * kb - 1) + 55)
                   + 4 * cls["n_qual"], peaks)
    byte_bound_ms = nbytes / peaks[0] * 1e3
    print(f"seed_classify: PASS  mma fragment layout error {mma_err:.3g}; "
          f"qualification agreement {cls['agree']:.9f} "
          f"({cls['n_disagree']} voxels differ), max |dqdiff| "
          f"{cls['max_abs_err']:.3g}, counts {cls['counts'][0]} vs "
          f"{cls['counts'][1]}, bit-identical {cls['identical']}; generic "
          f"radius path bit-identical {cls_gen['identical']} (max |dqdiff| "
          f"{cls_gen['max_abs_err']:.3g}); 7x75x203 stack: max |dqdiff| "
          f"{cls_odd['max_abs_err']:.3g}, {cls_odd['n_disagree']} voxels "
          f"differ; two launches equal; constant "
          f"stack counts 0 ({flat_qualified} voxels qualify at level "
          f"{N_LVL}); full range: max |dqdiff| {cls_full['max_abs_err']:.3g}"
          f", {cls_full['n_disagree']} voxels differ, counts "
          f"{cls_full['counts'][0]} vs {cls_full['counts'][1]}")
    print(f"kernels: seed_classify {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]}, bytes alone "
          f"{byte_bound_ms:.4f} ms); its mma.sync.m16n8k8 TF32 instruction "
          f"alone sustains {n_mma / mma_ms / 1e6:.2f} G products/s "
          f"({mma_tflops:.1f} TFLOP/s, 16 warps per SM, 8 independent "
          f"accumulators each)  [{smi}]")
    return {"cls": cls, "cls_gen": cls_gen, "cls_full": cls_full,
            "cls_odd": cls_odd,
            "mma_layout_err": mma_err, "flat_qualified": flat_qualified,
            "mma_rate_tflops": mma_tflops,
            "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "byte_bound_ms": byte_bound_ms, "zpass": zpass}


def _seed_pyramid_checks(torch, sk, corrected, k_fg, sig_bg, peaks,
                         smi: str) -> dict:
    """Everything held of seed_pyramid: kernel and plain version EQUAL
    (torch.equal on qdiff and counts) on the corrected 60x2048x2048 stack,
    on a ragged 12x196x260 crop (no side a multiple of the 16x64 tile, both
    image edges inside one block) and through the run-time-radius kernel
    (fg sigma 1.5, radius 6) on a 12x256x256 crop and on the ragged crop;
    a flat plateau counts nothing.  Then the kernel's
    registers (ptxas) and the resident warps per SM the card grants, and
    CUDA-event medians of kernel, plain version and the host prep
    (pyramid_background) over the fresh inputs, beside the bound."""
    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d

    dev = corrected[0].device

    def held(label, im, taps, th=TH_SEED):
        inp = (im, sk.pyramid_background(im, sig_bg), taps, th, N_LVL, EDGE)
        qk, ck = sk.fused_seed_classify_pyramid_cuda(*inp)
        qp, cp = sk.fused_seed_classify_pyramid_plain(*inp)
        torch.cuda.synchronize()
        fk, fp = torch.isfinite(qk), torch.isfinite(qp)
        both = fk & fp
        out = {"equal": torch.equal(qk, qp) and torch.equal(ck, cp),
               "max_abs_err": _max_abs(torch, qk[both], qp[both]),
               "n_disagree": int((fk != fp).sum()), "n_qual": int(fp.sum()),
               "n_sel": int((fp & (qp >= th)).sum()),
               "counts": (int(ck.sum()), int(cp.sum()))}
        if not out["equal"]:
            raise AssertionError(
                f"seed_pyramid {label}: kernel differs from its plain "
                f"version ({out['n_disagree']} voxels qualify differently, "
                f"max |dqdiff| {out['max_abs_err']}, counts "
                f"{out['counts']})")
        return out

    k_wide = gaussian_kernel1d(1.5)
    ragged = corrected[0][20:32, 300:496, 500:760].contiguous()
    checks = {
        "bench": held("bench scene", corrected[0], k_fg),
        "ragged": held("12x196x260", ragged, k_fg),
        "radius6": held("fg radius 6",
                        corrected[0][:12, :256, :256].contiguous(), k_wide),
        "radius6_ragged": held("fg radius 6, 12x196x260", ragged, k_wide)}
    flat = torch.full((8, 256, 256), 800.0, device=dev)
    _, cflat = sk.fused_seed_classify_pyramid_cuda(
        flat, sk.pyramid_background(flat, sig_bg), k_fg, 10.0, N_LVL, EDGE)
    if int(cflat.sum()) != 0:
        raise AssertionError(f"seed_pyramid: flat plateau gave "
                             f"{int(cflat.sum())} candidates")

    ptxas = _ptxas_report(_build.build_logs.get("seed_pyramid", ""))
    occupancy = {}
    for r in (len(k_fg) // 2, len(k_wide) // 2):
        blocks, threads, smem = sk.pyramid_occupancy_cuda(r)
        occupancy[r] = {"blocks_per_sm": blocks, "smem_bytes": smem,
                        "warps_per_sm": blocks * threads // 32}

    pyr_in = [(im, sk.pyramid_background(im, sig_bg), k_fg, TH_SEED, N_LVL,
               EDGE) for im in corrected]
    ms = _events_ms(torch, sk.fused_seed_classify_pyramid_cuda, pyr_in,
                    queue_ahead=True)
    plain_ms = _events_ms(torch, sk.fused_seed_classify_pyramid_plain,
                          pyr_in, queue_ahead=False)
    bg_ms = _events_ms(torch, sk.pyramid_background,
                       [(im, sig_bg) for im in corrected], queue_ahead=True)
    nvox = float(corrected[0].numel())
    taps = len(k_fg)
    nbytes = 4 * nvox * 2 + 4 * nvox / 16 + 4 * N_LVL
    # 3 separable passes of `taps` products and taps-1 sums, 9 for the
    # bilinear bg, 26 maxima, the difference and the compare; 4 more per
    # qualifying voxel for its level
    ops = nvox * (3 * (2 * taps - 1) + 9 + 26 + 2) \
        + 4 * checks["bench"]["n_qual"]
    bound = _bound(nbytes, ops, peaks)
    b = checks["bench"]
    print(f"seed_pyramid: PASS  equal to its plain version (qdiff and "
          f"counts) on the bench scene ({b['n_qual']} voxels qualify, "
          f"{b['n_sel']} selected, counts {b['counts'][0]}), on a ragged "
          f"12x196x260 stack and through the radius-6 kernel (12x256x256 "
          f"and ragged); flat plateau 0")
    for line in ptxas:
        print(f"  ptxas seed_pyramid: {line}")
    print(f"  occupancy seed_pyramid: "
          + ", ".join(f"fg radius {r}: {o['smem_bytes']} B shared memory "
                      f"a block, {o['blocks_per_sm']} blocks, "
                      f"{o['warps_per_sm']} warps per SM"
                      for r, o in occupancy.items()))
    print(f"kernels: seed_pyramid {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.3f} of "
          f"it); host prep pyramid_background {bg_ms:.4f} ms  [{smi}]")
    return {**checks["bench"], "checks": checks, "ptxas": ptxas,
            "occupancy": occupancy, "ms": ms, "plain_ms": plain_ms,
            "background_ms": bg_ms, "bound": bound}


def _check_dual_blur(torch, sk, inp) -> dict:
    """dual_blur against its plain version on one input: fg bit-identical
    (tap order on both sides), bg within the JAX tests' rtol 2e-5 / atol
    2e-2 (tests/test_pallas.py) where the taps take the tensor-core path,
    else bit-identical too."""
    fk, bk = sk.dual_blur_xy_cuda(*inp)
    fp, bp = sk.dual_blur_xy_plain(*inp)
    torch.cuda.synchronize()
    mma = (len(inp[2]), len(inp[3])) == sk.MMA_TAPS
    out = {"mma": mma, "fg_identical": torch.equal(fk, fp),
           "bg_identical": torch.equal(bk, bp),
           "within_tolerance": torch.allclose(bk, bp, rtol=2e-5, atol=2e-2),
           "max_abs_err": max(_max_abs(torch, fk, fp),
                              _max_abs(torch, bk, bp)),
           "bg_max_abs_err": _max_abs(torch, bk, bp)}
    out["identical"] = out["fg_identical"] and out["bg_identical"]
    if not out["fg_identical"]:
        raise AssertionError("dual_blur: fg differs from its plain version "
                             f"by {_max_abs(torch, fk, fp)}")
    if not (out["within_tolerance"] if mma else out["bg_identical"]):
        raise AssertionError(f"dual_blur: bg differs from its plain version "
                             f"by {out['bg_max_abs_err']} (tensor-core path "
                             f"{mma})")
    return out


def _dual_blur_checks(torch, sk, corrected, k_fg, k_bg, peaks,
                      smi: str) -> dict:
    """Everything held of dual_blur: (1) the default taps, whose bg runs on
    the tensor cores, on the bench scene's z-passed 60x2048x2048 stacks,
    on a 7x75x203 stack (narrower than the bg window, a width that is no
    multiple of 4) and on a full-range input (the stack scaled to reach
    65 535), each by _check_dual_blur; (2) the run-time-radius kernel (fg
    sigma 1.5 / bg sigma 5 on a 12x256x256 crop), bit-identical; (3) two
    launches on one input give equal outputs; (4) a constant 12x256x256
    stack counts nothing in the dual-blur path's 5^3 stencil
    (seeding._classify_from_blurs, filt_size 5).  Then ptxas registers and
    spills, the resident warps per SM, and at each launch shape the paths
    make (60x2048x2048, the bench scene; 30x2048x2048, the dual-blur and
    level-stencil paths' stacks) CUDA-event medians of kernel and plain
    version over three fresh inputs beside the bound."""
    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d
    from imageanalysis3_tpu_torch.ops.seeding import _classify_from_blurs

    dev = corrected[0].device
    bench = [(*sk.z_pass_pair(im, k_fg, k_bg), k_fg, k_bg)
             for im in corrected]
    checks = {"bench": _check_dual_blur(torch, sk, bench[0])}
    odd = corrected[0][20:27, 300:375, 500:703].contiguous()
    checks["odd"] = _check_dual_blur(
        torch, sk, (*sk.z_pass_pair(odd, k_fg, k_bg), k_fg, k_bg))
    gain = 65535.0 / float(corrected[0].max())
    checks["full_range"] = _check_dual_blur(
        torch, sk, (*sk.z_pass_pair(corrected[0] * gain, k_fg, k_bg), k_fg,
                    k_bg))
    k_fg2, k_bg2 = gaussian_kernel1d(1.5), gaussian_kernel1d(5.0)
    crop = corrected[0][:12, :256, :256].contiguous()
    checks["generic"] = _check_dual_blur(
        torch, sk, (*sk.z_pass_pair(crop, k_fg2, k_bg2), k_fg2, k_bg2))
    f1, b1 = sk.dual_blur_xy_cuda(*bench[1])
    f2, b2 = sk.dual_blur_xy_cuda(*bench[1])
    torch.cuda.synchronize()
    if not (torch.equal(f1, f2) and torch.equal(b1, b2)):
        raise AssertionError("dual_blur: two launches on one input differ")
    del f1, b1, f2, b2
    flat_shape = (12, 256, 256)
    flat = torch.full(flat_shape, 800.0, device=dev)
    ff, bf = sk.dual_blur_xy_cuda(*sk.z_pass_pair(flat, k_fg, k_bg), k_fg,
                                  k_bg)
    qf, cf = _classify_from_blurs(ff, bf, TH_SEED, 0, flat_shape[1],
                                  flat_shape, 5, EDGE, N_LVL)
    if int(cf.sum()) != 0:
        raise AssertionError(f"dual_blur: a constant stack counted "
                             f"{cf.tolist()} in the 5^3 stencil")
    flat_qualified = int(torch.isfinite(qf).sum())
    flat_bg_values = int(torch.unique(bf).numel())

    ptxas = _ptxas_report(_build.build_logs.get("dual_blur", ""))
    occupancy = {}
    for taps in ((len(k_fg), len(k_bg)), (len(k_fg2), len(k_bg2))):
        blocks, threads, smem = sk.dual_blur_occupancy_cuda(*taps)
        occupancy[str(taps)] = {"blocks_per_sm": blocks, "smem_bytes": smem,
                                "warps_per_sm": blocks * threads // 32}

    shapes = {}
    for inputs in (bench,
                   [(*sk.z_pass_pair(im[:DUAL_SHAPE[0]].contiguous(), k_fg,
                                     k_bg), k_fg, k_bg) for im in corrected]):
        name = "x".join(str(n) for n in inputs[0][0].shape)
        ms = _events_ms(torch, sk.dual_blur_xy_cuda, inputs,
                        queue_ahead=True)
        plain_ms = _events_ms(torch, sk.dual_blur_xy_plain, inputs,
                              queue_ahead=False)
        nvox = float(inputs[0][0].numel())
        kb, kf = len(k_bg), len(k_fg)
        # both stacks read once and written once; the x and y passes of
        # both stacks (k products, k-1 sums each) at the f32 rate
        bound = _bound(4 * nvox * 4,
                       nvox * (2 * (2 * kf - 1) + 2 * (2 * kb - 1)), peaks)
        shapes[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                        "bound_by": bound[1]}
    bench_t = shapes["x".join(str(n) for n in bench[0][0].shape)]
    del bench
    c = checks
    print(f"dual_blur: PASS  tensor-core path (taps {sk.MMA_TAPS}): fg "
          f"bit-identical, bg within rtol 2e-5 / atol 2e-2 of the plain "
          f"version (max |dbg| {c['bench']['bg_max_abs_err']:.3g} on the "
          f"bench scene, {c['odd']['bg_max_abs_err']:.3g} on 7x75x203, "
          f"{c['full_range']['bg_max_abs_err']:.3g} at full range); "
          f"run-time-radius path bit-identical {c['generic']['identical']}; "
          f"two launches equal; constant stack counts 0 in the 5^3 stencil "
          f"({flat_qualified} voxels qualify at level {N_LVL}, "
          f"{flat_bg_values} distinct bg values)")
    for line in ptxas:
        print(f"  ptxas dual_blur: {line}")
    print("  occupancy dual_blur: " + ", ".join(
        f"taps {t}: {o['smem_bytes']} B shared memory a block, "
        f"{o['blocks_per_sm']} blocks, {o['warps_per_sm']} warps per SM"
        for t, o in occupancy.items()))
    for name, t in shapes.items():
        print(f"kernels: dual_blur {name} {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}, {t['ms'] / t['bound_ms']:.2f}x)  [{smi}]")
    return {**checks["bench"], "checks": checks,
            "flat_qualified": flat_qualified, "ptxas": ptxas,
            "occupancy": occupancy, "shapes": shapes, "ms": bench_t["ms"],
            "plain_ms": bench_t["plain_ms"],
            "bound": (bench_t["bound_ms"], bench_t["bound_by"])}


def _stencil_vec(mx, mn) -> bool:
    """Whether csrc/level_stencil.cu takes its 16-byte-copy instance for
    these inputs (its launcher's rule; fresh outputs are aligned)."""
    return (mx.shape[-1] % 4 == 0 and mx.data_ptr() % 16 == 0
            and mn.data_ptr() % 16 == 0)


def _check_level_stencil(torch, sk, inp) -> dict:
    """level_stencil against its plain version on one input: level, counts
    and diff identical (torch.equal), diff also within rtol 1e-6."""
    lk, dk, ck = sk.level_stencil_cuda(*inp)
    lp, dp, cp = sk.level_stencil_plain(*inp)
    torch.cuda.synchronize()
    if not (torch.equal(lk, lp) and torch.equal(ck, cp)):
        raise AssertionError("level_stencil: level map or counts differ "
                             f"({int(ck.sum())} vs {int(cp.sum())} "
                             "counted)")
    if not torch.allclose(dk, dp, rtol=1e-6, atol=0.0):
        raise AssertionError("level_stencil: diff differs beyond rtol 1e-6")
    if not torch.equal(dk, dp):
        raise AssertionError(f"level_stencil: diff differs from the plain "
                             f"version by {_max_abs(torch, dk, dp)}")
    return {"max_abs_err": _max_abs(torch, dk, dp), "counts": int(ck.sum()),
            "shape": list(inp[0].shape), "vec": _stencil_vec(inp[0], inp[1])}


def _level_stencil_checks(torch, sk, blurs, peaks, smi: str) -> dict:
    """Everything held of level_stencil, each case by _check_level_stencil
    (level, counts and diff equal to the plain version's): the bench
    scene's blurs (fg, bg pairs) at 60x2048x2048 and their first 30 planes
    (the level-stencil path's shape); ragged 12x196x260 and 7x75x203 crops
    (ny % 4 = 3); a crop whose inputs start one float into their storage
    (the 4-byte-copy instance); nz = 1, 2, 3 at min_edge_distance 0;
    integer-valued plateau stacks full of ties (th 3); a constant stack,
    which must count 0; the blurs scaled to full range; n_lvl = 1 and 126;
    two launches that must be equal.  Then ptxas, the resident blocks and
    warps per SM and the waves of each instance, and at both full shapes
    CUDA-event medians of kernel and plain version over three fresh inputs
    beside the bound and the achieved TB/s, with ``torch.sub(mx, mn)``'s
    (12 of the kernel's 13 bytes a voxel) as the card's streaming
    yardstick; then the kernel's time on the bench blurs cut or extended
    along x to fill 7.0 to 8.5 waves."""
    from imageanalysis3_tpu_torch import _build

    fg, bg = blurs[0]
    dev = fg.device
    half = [(f[:DUAL_SHAPE[0]].contiguous(), b[:DUAL_SHAPE[0]].contiguous())
            for f, b in blurs]
    checks = {}

    def held(label, mx, mn, th=TH_SEED, n_lvl=N_LVL, edge=EDGE):
        checks[label] = _check_level_stencil(torch, sk,
                                             (mx, mn, th, n_lvl, edge))

    def crop(t, shape, at=(20, 300, 500)):
        return t[at[0]:at[0] + shape[0], at[1]:at[1] + shape[1],
                 at[2]:at[2] + shape[2]].contiguous()

    def offset(t):   # contiguous, one float into its storage
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    held("bench", fg, bg)
    held("half", *half[0])
    for shape in ((12, 196, 260), (7, 75, 203)):
        held("x".join(map(str, shape)), crop(fg, shape), crop(bg, shape))
    held("unaligned", offset(crop(fg, (12, 196, 260))),
         offset(crop(bg, (12, 196, 260))))
    for nz in (1, 2, 3):
        held(f"nz{nz}", crop(fg, (nz, 196, 260)), crop(bg, (nz, 196, 260)),
             edge=0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for shape in ((12, 256, 512), (7, 75, 203)):
        held(f"ties_{'x'.join(map(str, shape))}",
             torch.randint(0, 4, shape, device=dev, generator=gen).float(),
             torch.randint(0, 3, shape, device=dev, generator=gen).float(),
             th=3.0)
    flat = torch.full((12, 256, 256), 800.0, device=dev)
    held("constant", flat, flat.clone())
    gain = 65535.0 / float(half[0][0].max())
    held("full_range", half[0][0] * gain, half[0][1] * gain)
    held("n_lvl1", *half[1], n_lvl=1)
    held("n_lvl126", *half[1], n_lvl=126)
    if checks["unaligned"]["vec"] or checks["7x75x203"]["vec"]:
        raise AssertionError("level_stencil: a case meant for the 4-byte-"
                             "copy instance would take the 16-byte one")
    if checks["constant"]["counts"] != 0:
        raise AssertionError(f"level_stencil: a constant stack counted "
                             f"{checks['constant']['counts']}")
    if min(checks[k]["counts"] for k in ("bench", "ties_12x256x512")) == 0:
        raise AssertionError("level_stencil: a case meant to count "
                             "voxels counted none")
    first = sk.level_stencil_cuda(*half[2], TH_SEED, N_LVL, EDGE)
    second = sk.level_stencil_cuda(*half[2], TH_SEED, N_LVL, EDGE)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise AssertionError("level_stencil: two launches on one input "
                             "differ")
    del first, second

    ptxas = _ptxas_report(_build.build_logs.get("level_stencil", ""))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy = {}
    query = getattr(sk, "level_stencil_occupancy_cuda", None)
    for vec in (True, False) if query else ():
        blocks, threads, smem, tx, ty = query(vec)
        occupancy["16-byte" if vec else "4-byte"] = {
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "smem_bytes": smem, "tile": (tx, ty), "slots": blocks * sms}

    def waves(o, shape):   # tiles over resident blocks
        tx, ty = o["tile"]
        return -(-shape[1] // tx) * -(-shape[2] // ty) / o["slots"]

    for o in occupancy.values():
        o["waves"] = {"x".join(map(str, s)): waves(o, s)
                      for s in (SHAPE, DUAL_SHAPE)}

    shapes = {}
    for inputs in ([(f, b, TH_SEED, N_LVL, EDGE) for f, b in blurs],
                   [(f, b, TH_SEED, N_LVL, EDGE) for f, b in half]):
        name = "x".join(str(n) for n in inputs[0][0].shape)
        ms = _events_ms(torch, sk.level_stencil_cuda, inputs,
                        queue_ahead=True)
        plain_ms = _events_ms(torch, sk.level_stencil_plain, inputs,
                              queue_ahead=False)
        # the card's streaming yardstick: one elementwise call that moves
        # 12 of the kernel's 13 bytes a voxel (diff = mx - mn alone)
        out = torch.empty_like(inputs[0][0])
        sub_ms = _events_ms(torch, lambda m, n, *_: torch.sub(m, n, out=out),
                            inputs, queue_ahead=True)
        del out
        nvox = float(inputs[0][0].numel())
        nbytes = nvox * (4 + 4 + 4 + 1) + 4 * N_LVL
        # 26 maxima, 26 minima, the difference, two compares and the
        # level's 5 (divide, subtract, multiply, ceil, clip) on every voxel
        bound = _bound(nbytes, nvox * 60, peaks)
        shapes[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                        "bound_by": bound[1],
                        "tb_per_s": nbytes / (ms * 1e-3) / 1e12,
                        "sub_ms": sub_ms,
                        "sub_tb_per_s": 12 * nvox / (sub_ms * 1e-3) / 1e12}
    del half
    # the wave tail: the bench blurs cut or extended along x so that the
    # 16-byte instance's tiles fill 7.0 to 8.5 waves; a time a voxel that
    # steps with the waves' ceiling is what the tail costs
    sweep = {}
    for nx in (1856, 1984, 2048, 2112, 2240) if occupancy else ():
        def at(t):
            return (t[:, :nx] if nx <= t.shape[1] else
                    torch.cat([t, t[:, :nx - t.shape[1]]], 1)).contiguous()
        inputs = [(at(f), at(b), TH_SEED, N_LVL, EDGE) for f, b in blurs]
        ms = _events_ms(torch, sk.level_stencil_cuda, inputs,
                        queue_ahead=True)
        sweep[nx] = {"waves": waves(occupancy["16-byte"], inputs[0][0].shape),
                     "ms": ms, "ps_per_voxel": ms * 1e9 / inputs[0][0].numel()}
        del inputs
    bench_t = shapes["x".join(str(n) for n in fg.shape)]
    print(f"level_stencil: PASS  level, counts and diff equal to the plain "
          f"version (torch.equal) on " + ", ".join(
              f"{k} ({v['counts']} counted"
              f"{'' if v['vec'] else ', 4-byte copies'})"
              for k, v in checks.items()) + "; two launches equal")
    for line in ptxas:
        print(f"  ptxas level_stencil: {line}")
    for inst, o in occupancy.items():
        print(f"  occupancy level_stencil ({inst} copies): {o['smem_bytes']} "
              f"B shared memory a block, {o['blocks_per_sm']} blocks, "
              f"{o['warps_per_sm']} warps per SM, tile {o['tile']}, waves "
              + ", ".join(f"{k}: {w:.2f}" for k, w in o["waves"].items()))
    for name, t in shapes.items():
        print(f"kernels: level_stencil {name} {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}, {t['ms'] / t['bound_ms']:.2f}x, "
              f"{t['tb_per_s']:.3f} TB/s; torch.sub alone {t['sub_ms']:.4f} "
              f"ms, {t['sub_tb_per_s']:.3f} TB/s)  [{smi}]")
    if sweep:
        print(f"  waves level_stencil ({fg.shape[0]} x nx x {fg.shape[2]}, "
              f"the bench blurs): " + ", ".join(
                  f"nx {nx}: {w['waves']:.2f} waves {w['ms']:.4f} ms "
                  f"{w['ps_per_voxel']:.4f} ps/voxel"
                  for nx, w in sweep.items()))
    return {**checks["bench"], "checks": checks, "ptxas": ptxas,
            "occupancy": occupancy, "waves_sweep": sweep,
            "shapes": shapes, "ms": bench_t["ms"],
            "plain_ms": bench_t["plain_ms"],
            "bound": (bench_t["bound_ms"], bench_t["bound_by"])}


def _dual_blur_phase(torch, smi: str) -> dict:
    """The dual-blur path: ``FovPipeline.process_round`` with
    ``SeedConfig(pyramid_bg=False, filt_size=5)`` on a 30x2048x2048 stack
    (the package's DEFAULT_IMAGE_SIZE) of 1800 planted spots; dual_blur must
    launch once per round (one fit channel), lm_fit and gather_cubes at
    least once, and each round must meet
    bench.py's accuracy gate.  Then the level-stencil path on one corrected
    stack: the ``dual_gaussian_blur`` and ``level_stencil`` entry points,
    whose counts and level map must equal the plain stencil's
    (seeding._classify_from_blurs) on the same blurs."""
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches,
                                              seed_kernels)
    from imageanalysis3_tpu_torch.ops.seeding import _classify_from_blurs
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    dev = torch.device("cuda")
    truth = syn.sample_spot_params(DUAL_SHAPE, N_SPOTS,
                                   np.random.default_rng(1),
                                   min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    base = syn.render_spots(DUAL_SHAPE, truth["centers"], truth["heights"],
                            background=truth["background"], device=dev)
    raws = [syn.noisy_uint16(base, seed=200 + k) for k in range(4)]
    del base
    cfg = ExperimentConfig(
        image_size=DUAL_SHAPE,
        seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048,
                        pyramid_bg=False, filt_size=5),
        fit=FitConfig())
    pipe = FovPipeline(cfg, n_channels=1, drift_channel_index=0,
                       fit_channel_indices=(0,), image_shape=DUAL_SHAPE)
    ref_im = pipe.prepare_reference(pipe.correct_reference(raws[0][None]))
    pipe.process_round(raws[1][None], ref_im)          # warm-up
    times, launches, acc = [], [], []
    for k, raw in enumerate(raws[2:]):
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        res = pipe.process_round(raw[None], ref_im)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = kernel_launches()
        launches.append(counts)
        if (counts["dual_blur"] != 1 or counts["lm_fit"] < 1
                or counts["gather_cubes"] < 1):
            raise AssertionError(f"dual-blur path round {k}: launches "
                                 f"{counts}")
        if counts["seed_classify"] or counts["seed_pyramid"]:
            raise AssertionError(f"dual-blur path round {k} ran another "
                                 f"classifier: {counts}")
        acc.append(_check_accuracy(f"dual-blur round {k}", res,
                                   truth["centers"]))

    s = cfg.seed
    corr = pipe.correct_one(raws[2], 0)
    torch.cuda.synchronize()
    reset_kernel_launches()
    fg, bg = seed_kernels.dual_gaussian_blur(corr, s.gfilt_size,
                                             s.background_gfilt_size)
    level, diff, counts_l = seed_kernels.level_stencil(fg, bg, TH_SEED, N_LVL,
                                                       EDGE)
    torch.cuda.synchronize()
    lvl_launches = kernel_launches()
    if lvl_launches["dual_blur"] != 1 or lvl_launches["level_stencil"] != 1:
        raise AssertionError(f"level-stencil path launches {lvl_launches}")
    q, c = _classify_from_blurs(fg, bg, TH_SEED, 0, DUAL_SHAPE[1], DUAL_SHAPE,
                                3, EDGE, N_LVL)
    in_budget = seed_kernels._levels(q, TH_SEED, N_LVL) < N_LVL
    if not (torch.equal(counts_l, c) and torch.equal(level < N_LVL, in_budget)
            and torch.equal(diff, fg - bg)):
        raise AssertionError("level-stencil path: level map or counts differ "
                             "from the plain stencil on the same blurs")
    sec = statistics.median(times)
    print(f"dual-blur path: {sec:.4f} s/stack (rounds "
          f"{[round(t, 4) for t in times]}), launches per round {launches}; "
          f"level-stencil path: {int(counts_l.sum())} voxels counted, equal "
          f"to the plain stencil, launches {lvl_launches}  [{smi}]")
    return {"shape": DUAL_SHAPE, "seconds_per_stack": sec,
            "round_seconds": times, "launches_per_round": launches,
            "accuracy": acc, "level_stencil_launches": lvl_launches,
            "level_stencil_counted": int(counts_l.sum())}


def _e2e_phase(torch, smi: str) -> dict:
    """bench_e2e.py's end-to-end path with the exact classifier: 20 rounds
    of 3-channel 60x2048x2048 stacks (2 data channels + beads, rendered on
    the card one round at a time), ``FovPipeline.process_round`` on each,
    then ``DNAMerfishDecoder.decode`` of all candidate spots into 300
    homolog region traces.  seed_classify must launch on every data
    channel of every round and lm_fit and gather_cubes with it; >= 285 of
    300 regions
    assigned; median trace error <= 1.25x the planted-jitter floor (the
    error of the mean of each region's planted, jittered spots); median
    drift error <= 0.1 px."""
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.decode import DNAMerfishDecoder
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    scene = syn.make_e2e_scene()
    n_data = scene.n_data_ch
    cfg = ExperimentConfig(
        image_size=scene.shape,
        seed=SeedConfig(th_seed=300.0, max_num_seeds=4096, pyramid_bg=False),
        fit=FitConfig())
    pipe = FovPipeline(cfg, n_channels=n_data + 1, drift_channel_index=n_data,
                       fit_channel_indices=tuple(range(n_data)),
                       image_shape=scene.shape)
    ims = scene.round_stack(0)
    ref_im = pipe.prepare_reference(pipe.correct_reference(ims))
    pipe.process_round(ims, ref_im)                    # warm-up
    del ims
    t_render, t_proc, drift_errs, launches = [], [], [], []
    all_spots, all_bits = [], []
    for r in range(scene.n_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ims = scene.round_stack(r)
        torch.cuda.synchronize()
        t_render.append(time.perf_counter() - t0)
        reset_kernel_launches()
        t0 = time.perf_counter()
        res = pipe.process_round(ims, ref_im)
        torch.cuda.synchronize()
        t_proc.append(time.perf_counter() - t0)
        counts = kernel_launches()
        launches.append(counts)
        if (counts["seed_classify"] != n_data or counts["lm_fit"] < n_data
                or counts["gather_cubes"] < n_data):
            raise AssertionError(f"e2e round {r}: launches {counts}")
        drift_errs.append(float(np.linalg.norm(
            res.drift.cpu().numpy() + scene.drifts[r])))
        spots, valid = res.spots.cpu().numpy(), res.valid.cpu().numpy()
        for ci in range(n_data):
            all_spots.append(spots[ci][valid[ci]])
            # codebook bit columns are 1-based ("1".."40")
            all_bits.append(np.full(int(valid[ci].sum()), r * n_data + ci + 1))
        del ims, res
    # the round's split by stage, on three more renders of rounds 1-3 (all
    # warm by now): the three channels' corrections, the drift against the
    # reference, the two data channels' seeding and fits
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    split = {"correct": [], "drift": [], "fit": []}
    for r in (1, 2, 3):
        ims = scene.round_stack(r)
        corr, t = timed(lambda: [pipe.correct_one(ims[ci], ci)
                                 for ci in range(n_data + 1)])
        split["correct"].append(t)
        split["drift"].append(timed(
            lambda: pipe.drift_of(corr[n_data], ref_im))[1])
        split["fit"].append(timed(lambda: [
            pipe.fit_channel(corr[ci], float(pipe.seed_thresholds[ci]))
            for ci in range(n_data)])[1])
        del ims, corr
    stages = {k: statistics.median(v) for k, v in split.items()}

    spots = np.concatenate(all_spots).astype(np.float32)
    bits = np.concatenate(all_bits)

    dec = DNAMerfishDecoder(scene.codebook, pair_search_radius=250.0,
                            keep_ratio_th=0.2)
    t0 = time.perf_counter()
    dec.decode(spots, bits)
    t_decode_first = time.perf_counter() - t0
    first_stages = dict(dec.stage_seconds)
    t0 = time.perf_counter()
    out = dec.decode(spots, bits)
    t_decode = time.perf_counter() - t0
    if out is None:
        raise AssertionError("e2e: the keep-ratio gate refused the cell")
    decode_spans = _decode_spans(torch, dec, spots, bits, out, smi)
    # the decoded groups, for phase 9's self-scores: the spot table padded
    # as the decoder padded it, positions in nm
    n_pad = len(dec.spot_groups.spot_usage)
    spots_t = torch.zeros((n_pad, 11), device="cuda")
    spots_t[:len(spots)] = torch.as_tensor(spots, device="cuda")
    valid_t = torch.arange(n_pad, device="cuda") < len(spots)
    decoded = (dec.spot_groups, spots_t, spots_t[:, 1:4] * torch.as_tensor(
        dec.pixel_sizes, device="cuda"), valid_t)

    px = np.asarray(syn.E2E_PIXEL_SIZE_NM)
    n_chr = len(set(scene.codebook["chr"]))
    n_h = 2
    errs, floor, n_assigned = [], [], 0
    for c in range(n_chr):
        for h in range(n_h):
            floor.extend(np.linalg.norm(
                (scene.region_spots[(c, h)].mean(axis=1)
                 - scene.truth[(c, h)]) * px, axis=1).tolist())
        res = out.get(f"chr{c + 1}")
        if res is None:
            continue
        zxys, ok = res.zxys.cpu().numpy(), res.zxys_valid.cpu().numpy()
        t_nm = np.stack([scene.truth[(c, h)] * px for h in range(n_h)])
        best = None
        for perm in ((0, 1), (1, 0)):
            d = np.linalg.norm(zxys - t_nm[list(perm)], axis=-1)
            tot = np.nansum(np.where(ok, d, np.nan))
            if best is None or tot < best[0]:
                best = (tot, d)
        errs.extend(best[1][ok].tolist())
        n_assigned += int(ok.sum())
    n_regions = len(floor)
    med_err = float(np.median(errs)) if errs else float("nan")
    med_floor = float(np.median(floor))
    med_drift = float(np.median(drift_errs))
    sec = statistics.median(t_proc)
    print(f"e2e: {sec:.4f} s/round (median of {len(t_proc)} rounds, render "
          f"{statistics.median(t_render):.4f} s/round excluded; stages "
          f"{ {k: round(v, 4) for k, v in stages.items()} } s: {n_data + 1} "
          f"corrections, 1 drift, {n_data} fits), decode "
          f"{t_decode:.3f} s (tuples {dec.stage_seconds['tuples']:.3f}, "
          f"homolog {dec.stage_seconds['homolog']:.3f}; first call "
          f"{t_decode_first:.3f}), {len(spots)} candidate spots, regions "
          f"assigned {n_assigned}/{n_regions}, median trace error "
          f"{med_err:.2f} nm (planted-jitter floor {med_floor:.2f} nm, "
          f"ratio {med_err / med_floor:.3f}), median drift error "
          f"{med_drift:.4f} px, launches per round {launches[0]}  [{smi}]")
    if n_assigned < 285:
        raise AssertionError(f"e2e: {n_assigned} of {n_regions} regions "
                             "assigned (< 285)")
    if not med_err <= 1.25 * med_floor:
        raise AssertionError(f"e2e: median trace error {med_err} nm > 1.25 x "
                             f"the planted-jitter floor {med_floor} nm")
    if not med_drift <= 0.1:
        raise AssertionError(f"e2e: median drift error {med_drift} px > 0.1")
    return {"seconds_per_round": sec, "round_seconds": t_proc,
            "stage_seconds": stages,
            "render_seconds": t_render, "decode_seconds": t_decode,
            "decode_stage_seconds": dict(dec.stage_seconds),
            "decode_first_call_seconds": t_decode_first,
            "decode_first_stage_seconds": first_stages,
            "decode_spans": decode_spans,
            "candidate_spots": int(len(spots)),
            "regions_assigned": n_assigned, "regions_total": n_regions,
            "median_trace_err_nm": med_err,
            "planted_jitter_floor_nm": med_floor,
            "median_drift_err_px": med_drift, "drift_errs_px": drift_errs,
            "launches_per_round": launches,
            "seed_classify_launches": sum(c["seed_classify"]
                                          for c in launches),
            "decoded": decoded}


def _decode_spans(torch, dec, spots, bits, out, smi: str) -> dict:
    """One more decode under the timing record: the ``decode`` span's and
    its ``tuples`` and ``homolog`` spans' event intervals and host times,
    its candidates, groups and waits on the card (counted; unlike a
    round's, they need not sit in sync spans: the decode's host loops read
    the card by design); the outputs equal to the unrecorded decode's."""
    from imageanalysis3_tpu_torch import tracing

    tracing.clear()
    with tracing.recording():
        again = dec.decode(spots, bits)
    spans = {sp.name: sp for sp in tracing.record().loose}
    tracing.clear()
    if sorted(again) != sorted(out) or any(
            not torch.equal(torch.nan_to_num(getattr(again[c], f)),
                            torch.nan_to_num(getattr(out[c], f)))
            for c in out for f in ("zxys", "zxys_valid", "sel_group")):
        raise AssertionError("e2e: the decode's outputs differ with the "
                             "timing record on")
    top = spans["decode"]
    rec = {name: {"device_ms": sp.device_ms, "host_ms": sp.host_ms}
           for name, sp in spans.items()}
    rec["attrs"] = dict(top.attrs)
    print(f"e2e decode spans: decode {rec['decode']['device_ms']:.2f} ms "
          f"(host {rec['decode']['host_ms']:.2f}), tuples "
          f"{rec['tuples']['device_ms']:.2f}, homolog "
          f"{rec['homolog']['device_ms']:.2f} ms; candidates "
          f"{top.attrs['candidates']}, groups {top.attrs['groups']}, waits "
          f"on the card {top.attrs['syncs']} ({top.attrs['unmarked_syncs']} "
          f"outside a sync span)  [{smi}]")
    return rec


#: the gather's launch shapes on the paths: (seed capacity, fit radius) of
#: slice 1, the dual-blur path and calibration (d); the e2e path; the
#: chromatic beads (c); the bleed fits (b) and their regression crops
#: (profiles.fit_spot_pair_regressions' crop_radius)
GATHER_SHAPES = {"slice1": (2048, 5), "e2e": (4096, 5),
                 "calibration_beads": (512, 5), "bleed_fit": (256, 5),
                 "bleed_crop": (256, 4), "r6": (2048, 6)}


def _gather_blocks_times(torch, stacks, centers, smi: str) -> dict:
    """``gaussian_fit.gather_blocks`` whole (seed conversion and gather) at
    every GATHER_SHAPES shape, seeds at the planted centres (the rest of the
    capacity at -1, as get_seeds pads its table): the CUDA-event median over
    the three stacks, the gather launches a call makes and the device memory
    it takes beyond its outputs.  Uses nothing but gather_blocks and the
    launch counters, so it also times an older tree's gather_blocks."""
    from imageanalysis3_tpu_torch.ops import (gaussian_fit, kernel_launches,
                                              reset_kernel_launches)

    dev = stacks[0].device
    out = {}
    for name, (cap, radius) in GATHER_SHAPES.items():
        inputs = [(im, _planted_seeds(torch, centers, cap, dev)[0], radius)
                  for im in stacks]
        ms = _events_ms(torch, gaussian_fit.gather_blocks, inputs,
                        queue_ahead=True)
        torch.cuda.synchronize()
        reset_kernel_launches()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = gaussian_fit.gather_blocks(*inputs[0])
        torch.cuda.synchronize()
        outputs = sum(t.numel() * t.element_size() for t in res)
        extra = torch.cuda.max_memory_allocated() - before - outputs
        out[name] = {"seeds": cap, "radius": radius, "ms": ms,
                     "launches": kernel_launches()["gather_cubes"],
                     "output_bytes": outputs, "extra_bytes": int(extra)}
        del res, inputs
        print(f"gather_blocks {name}: {cap} seeds, r = {radius}: "
              f"{ms:.4f} ms whole, {out[name]['launches']} gather launch(es) "
              f"a call, {extra} B of device memory beyond its "
              f"{outputs} B of outputs  [{smi}]")
    return out


def _ball_flat_index(torch, gk, shape, seeds, radius):
    """(N, P) int64 flat indices into the stack of gather_ball's pixels:
    the index the one PyTorch call ``im.reshape(-1)[idx]`` takes."""
    sides = gk.cube_sides(shape, radius)
    offs, _, last = gk._ball_constants(tuple(shape), radius, seeds.device)
    b = gk._to_int32(seeds).to(torch.int64)
    pos = gk._wrap_int32(b[:, None, :] + offs[None])
    origin = gk.clip_origins(gk._wrap_int32(b - radius), shape,
                             sides).to(torch.int64)
    rel = torch.minimum(gk._wrap_int32(pos - origin[:, None]).clamp_min(0),
                        last)
    v = origin[:, None] + rel
    return (v[..., 0] * shape[1] + v[..., 1]) * shape[2] + v[..., 2]


def _gather_checks(torch, stacks, centers, peaks, smi: str) -> dict:
    """Both gather entries against their plain versions, exactly
    (torch.equal, max_abs_err 0), each case over three fresh inputs, seeds
    at the planted centres (the rest of the capacity at -1, as get_seeds
    pads its table).  The cube entry: 2048 seeds with r = 5 and r = 4 (the
    origins handed over unclipped, as seed - r, so the kernel's own
    clipping runs), a thin stack (the first 6 planes, sz = 6 < 2r) and
    origins drawn far outside the stack (int32 extremes included).  The
    ball entry (pixels, coords and mask against the plain cube-then-pack):
    every GATHER_SHAPES shape with f32 seeds, the thin stack, f32 seeds
    with non-finite and huge rows (converted as XLA converts them), and
    int32 positions far outside (int32 extremes included, where the sums
    wrap).  Each case reports the
    kernel's CUDA-event median ms, the plain version's, the one PyTorch
    call's on a precomputed flat index (``im.reshape(-1)[idx]``) and the
    byte bound (every value read once and written once).  Then
    gather_blocks whole at every shape (_gather_blocks_times), which must
    make one gather launch a call and no cube array."""
    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch.ops import gather_kernel as gk

    dev = stacks[0].device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)

    def outside(n):
        big = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 3), generator=gen,
                            dtype=torch.int64)
        big[: n // 4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -7])
        return big.to(torch.int32).to(dev)

    def seeds(cap):
        return [_planted_seeds(torch, centers, cap, dev)[0] for _ in stacks]

    def nonfinite(s):
        s = s.clone()
        s[:6] = torch.tensor(
            [[float("nan"), 3.0, 3.0], [float("inf"), -float("inf"), 2.0],
             [1e10, -1e10, 5.0], [float("nan")] * 3, [2147483520.0, -3.0, 5.0],
             [-2147483520.0, 5.0, 2147483520.0]])
        return s

    thin = [im[:6].contiguous() for im in stacks]
    s2048 = seeds(2048)
    cube_cases = {
        "r5": [(im, (s - 5).to(torch.int32), gk.cube_sides(im.shape, 5))
               for im, s in zip(stacks, s2048)],
        "r4": [(im, (s - 4).to(torch.int32), gk.cube_sides(im.shape, 4))
               for im, s in zip(stacks, s2048)],
        "thin_r5": [(im, (s - 5).to(torch.int32), gk.cube_sides(im.shape, 5))
                    for im, s in zip(thin, s2048)],
        "outside_r5": [(im, outside(2048), gk.cube_sides(im.shape, 5))
                       for im in stacks],
    }
    # f32 seeds, as gather_blocks hands them over; int32 ones far outside
    ball_cases = {name: [(im, s, r) for im, s in zip(stacks, seeds(cap))]
                  for name, (cap, r) in GATHER_SHAPES.items()}
    ball_cases["thin_r5"] = [(im, s, 5) for im, s in zip(thin, s2048)]
    ball_cases["nonfinite_r5"] = [(im, nonfinite(s), 5)
                                  for im, s in zip(stacks, s2048)]
    ball_cases["outside_r5"] = [(im, outside(2048), 5) for im in stacks]

    def report(entry, name, inputs, kernel, plain, idx_of, nbytes):
        for inp in inputs:
            got, want = kernel(*inp), plain(*inp)
            torch.cuda.synchronize()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{entry} {name}: differs from its plain version "
                        f"(max |d| {_max_abs(torch, g.float(), w.float())})")
        ms = _events_ms(torch, kernel, inputs, queue_ahead=True)
        plain_ms = _events_ms(torch, plain, inputs, queue_ahead=False)
        lib_in = [(inp[0], idx_of(*inp)) for inp in inputs]
        lib_ms = _events_ms(torch, lambda im, idx: im.reshape(-1)[idx],
                            lib_in, queue_ahead=True)
        bound = _bound(nbytes, 0.0, peaks)
        rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound[0],
               "bound_by": bound[1]}
        print(f"{entry} {name}: PASS  equal to its plain version; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, im.reshape(-1)[idx] "
              f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
              f"({ms / bound[0]:.2f}x)  [{smi}]")
        return rec

    cubes, balls = {}, {}
    for name, inputs in cube_cases.items():
        n, sides = inputs[0][1].shape[0], inputs[0][2]
        vol = sides[0] * sides[1] * sides[2]
        cubes[name] = {"cubes": n, "sides": list(sides), **report(
            "gather_cubes (cubes)", f"{name}, {n} cubes of {sides}", inputs,
            gk.gather_cubes_cuda, gk.gather_cubes_plain,
            lambda im, o, sd: gk.cube_index(im.shape, o, sd),
            2 * 4 * n * vol + 12 * n)}
    for name, inputs in ball_cases.items():
        n, r = inputs[0][1].shape[0], inputs[0][2]
        p = len(gk.ball_offsets(r))
        # pixels read once; base and offsets read; pixels, coords and the
        # mask written once
        balls[name] = {"seeds": n, "radius": r, "px": p, **report(
            "gather_cubes (ball)", f"{name}, {n} seeds x {p} px (r = {r})",
            inputs, gk.gather_ball_cuda, gk.gather_ball_plain,
            lambda im, b, rr: _ball_flat_index(torch, gk, im.shape, b, rr),
            n * p * (4 + 4 + 12 + 1) + 12 * (n + p))}
    whole = _gather_blocks_times(torch, stacks, centers, smi)
    for name, w in whole.items():
        cap, r = GATHER_SHAPES[name]
        sides = gk.cube_sides(stacks[0].shape, r)
        cube_bytes = 4 * cap * sides[0] * sides[1] * sides[2]
        if w["launches"] != 1 or w["extra_bytes"] >= cube_bytes:
            raise AssertionError(
                f"gather_blocks {name}: {w['launches']} gather launches and "
                f"{w['extra_bytes']} B beyond its outputs (a cube array "
                f"takes {cube_bytes} B)")
    ptxas = _ptxas_report(_build.build_logs.get("gather_cubes", ""))
    for line in ptxas:
        print(f"  ptxas gather_cubes: {line}")
    occupancy = {}
    for entry in ("cubes", "ball"):
        blocks, threads = gk.gather_occupancy_cuda(entry == "ball")
        occupancy[entry] = {"blocks_per_sm": blocks,
                            "warps_per_sm": blocks * threads // 32}
    print("  occupancy gather_cubes: " + ", ".join(
        f"{e} entry: {o['blocks_per_sm']} blocks, {o['warps_per_sm']} warps "
        f"per SM" for e, o in occupancy.items())
        + f"  [{smi}]")
    return {"cubes": cubes, "ball": balls, "gather_blocks": whole,
            "ptxas": ptxas, "occupancy": occupancy}


# ---- the LM fit at every launch shape the paths make ------------------------
def _lm_round0(torch, im, s, valid, radius: int, lm_iters: int) -> dict:
    """Round-0 inputs of ``iter_fit_seed_points`` for seeds `s` (N, 3)
    f32: ownership-masked blocks, the contested/isolated centre boxes and
    the moment-based start."""
    from imageanalysis3_tpu_torch.config import FitConfig
    from imageanalysis3_tpu_torch.ops import gaussian_fit as gf

    f = FitConfig()
    pixels, coords, base = gf.gather_blocks(im, s, radius)
    base = base & valid[:, None]
    nidx, nmask = gf.neighbor_lists(s, valid, max_neighbors=f.max_neighbors,
                                    radius=radius)
    own = gf.ownership_mask(coords, s, s[nidx], nmask)
    contested = nmask.any(dim=1) & valid
    delta = torch.where(contested, f.min_delta_center,
                        f.max_delta_center).to(torch.float32)
    mask = (base & own).contiguous()
    p0 = gf.init_params(pixels, mask, f.min_w, f.max_w, f.init_w,
                        coords=coords, center_est=s, delta=delta)
    lm_in = (pixels.contiguous(), coords.contiguous(), mask, s.contiguous(),
             delta.contiguous(), p0.contiguous(), f.min_w, f.max_w, lm_iters)
    return {"lm_in": lm_in, "svalid": valid, "base": base, "nidx": nidx,
            "nmask": nmask, "contested": contested}


def _lm_refit(torch, r0: dict, prm, eps):
    """One Jacobi refit round's inputs, built from round-0 results as
    iter_fit_seed_points builds them: warm-started params rebased into the
    wide box, the contested prefix of capacity max(128, N/4 rounded up to
    128), pixels with the neighbours' reconstructions subtracted, and
    max(8, lm_iters // 3) iterations."""
    from imageanalysis3_tpu_torch.config import FitConfig
    from imageanalysis3_tpu_torch.ops import gaussian_fit as gf

    f = FitConfig()
    pixels, coords, _, s, delta0 = r0["lm_in"][:5]
    min_w, max_w, lm_iters = r0["lm_in"][6:9]
    nat = gf.to_natural(prm, s, delta0, min_w, max_w, eps)
    prm = gf.rebase_center_params(prm, s, delta0, f.max_delta_center)
    n = s.shape[0]
    cap = min(n, max(128, -(-n // 4 // 128) * 128))
    sel = torch.argsort((~r0["contested"]).to(torch.int8), stable=True)[:cap]
    sub = gf._recon_at(coords[sel], nat, r0["nidx"][sel], r0["nmask"][sel])
    delta = torch.full((cap,), f.max_delta_center, dtype=torch.float32,
                       device=s.device)
    return ((pixels[sel] - sub).contiguous(), coords[sel].contiguous(),
            r0["base"][sel].contiguous(), s[sel].contiguous(), delta,
            prm[sel].contiguous(), min_w, max_w, max(8, lm_iters // 3)), sel


def _check_lm(torch, label, lm_in, svalid, base, shape, order_px=None,
              cap=None):
    """lm_fit kernel against its plain version on one batch: finite
    outputs; then, on every valid spot whose fit the summation order does
    not decide, identical valid masks, centres within 1e-3 px, heights
    within rtol 1e-2, widths within 1e-3.  A spot's fit is decided by the
    order when the plain version itself, run on the spot's pixels in two
    other orders (reversed, rotated by half), moves beyond those
    tolerances or changes its validity: such spots (an LM step whose
    accept or reject turns on rounding) are named and counted, and more
    than max(2, 1 %) of the valid spots fails the check.  A caller may
    state its own rule: `order_px`, a centre move that marks a spot as
    decided in place of 1e-3 px, and `cap`, the most decided spots
    allowed.  Returns (max |dcentre| over the held spots, n valid, the
    plain version's (params, eps), the order-decided spots)."""
    from imageanalysis3_tpu_torch.ops import gaussian_fit as gf
    from imageanalysis3_tpu_torch.ops import lm_kernel

    pk, ek = lm_kernel.lm_fit_cuda(*lm_in)
    pp, ep = lm_kernel.lm_fit_plain(*lm_in)
    torch.cuda.synchronize()
    if not (torch.isfinite(pk).all() and torch.isfinite(ek).all()):
        raise AssertionError(f"lm_fit {label}: non-finite params or eps "
                             "from the kernel (padded/invalid spots "
                             "included)")
    size = torch.tensor(shape, dtype=torch.float32, device=pk.device)

    def natural(prm, eps):
        nat = gf.to_natural(prm, lm_in[3], lm_in[4], lm_in[6], lm_in[7], eps)
        ok = (svalid & torch.isfinite(nat).all(dim=1)
              & ((nat[:, 1:4] > 0) & (nat[:, 1:4] < size)).all(dim=1)
              & (base.sum(dim=1) > 10))
        return nat, ok

    def apart(a, va, b, vb, centre=1e-3):
        """Spots on which two fits differ beyond the tolerances."""
        return ((va != vb) | ((va & vb) & (
            ((a[:, 1:4] - b[:, 1:4]).abs() > centre).any(dim=1)
            | ((a[:, 0] - b[:, 0]).abs() > 1e-2 * b[:, 0].abs())
            | ((a[:, 5:8] - b[:, 5:8]).abs() > 1e-3).any(dim=1))))

    nk, vk = natural(pk, ek)
    npl, vp = natural(pp, ep)
    p = lm_in[0].shape[1]
    decided = torch.zeros_like(vp)
    for perm in (torch.arange(p - 1, -1, -1), torch.roll(torch.arange(p),
                                                         p // 2)):
        perm = perm.to(pk.device)
        po, eo = lm_kernel.lm_fit_plain(lm_in[0][:, perm], lm_in[1][:, perm],
                                        lm_in[2][:, perm], *lm_in[3:])
        decided |= apart(*natural(po, eo), npl, vp, order_px or 1e-3)
    held = ~decided
    names = torch.nonzero(decided & (vp | vk)).flatten().tolist()
    if len(names) > (max(2, int(vp.sum()) // 100) if cap is None else cap):
        raise AssertionError(f"lm_fit {label}: {len(names)} spots are "
                             f"decided by the summation order: {names}")
    if not torch.equal(vk[held], vp[held]):
        raise AssertionError(f"lm_fit {label}: valid masks differ "
                             f"({int(vk[held].sum())} vs "
                             f"{int(vp[held].sum())})")
    both = vp & held
    ck_, cp_ = nk[both][:, 1:4], npl[both][:, 1:4]
    err = float((ck_ - cp_).abs().max()) if int(both.sum()) else 0.0
    if not torch.allclose(ck_, cp_, rtol=0.0, atol=1e-3):
        bad = torch.nonzero(both).flatten()[
            ((ck_ - cp_).abs() > 1e-3).any(dim=1)].tolist()
        raise AssertionError(f"lm_fit {label}: centres differ by {err} px "
                             f"(spots {bad})")
    if not torch.allclose(nk[both][:, 0], npl[both][:, 0], rtol=1e-2,
                          atol=0.0):
        raise AssertionError(f"lm_fit {label}: heights differ beyond "
                             "rtol 1e-2")
    if not torch.allclose(nk[both][:, 5:8], npl[both][:, 5:8], rtol=0.0,
                          atol=1e-3):
        raise AssertionError(f"lm_fit {label}: widths differ beyond "
                             "atol 1e-3")
    return err, int(vp.sum()), (pp, ep), names


def _lm_bound(n: int, p: int, iters: int, peaks):
    """The least time of the reference algorithm's work for n spots of p
    pixels and `iters` iterations: bytes read once (pixels, coordinates,
    mask, centres, delta, params) and written once (params, eps); per pixel
    240 flop for model, residual, 10 J^T rows, g and the 55 H sums, 31 for
    the trial cost, 31 each for the first cost and eps; per spot and
    iteration 12 CG steps of ~260 flop."""
    nbytes = n * p * (4 + 12 + 1) + n * (12 + 4 + 40 + 44)
    ops = n * (p * (iters * 271 + 62) + iters * 12 * 260)
    return _bound(nbytes, ops, peaks)


def _planted_seeds(torch, centers, capacity: int, dev):
    """Seeds at the planted centres (rounded, the first `capacity`), the
    rest of the capacity invalid at -1, as get_seeds pads its table."""
    c = np.round(np.asarray(centers, np.float64))[:capacity]
    s = np.full((capacity, 3), -1.0, np.float32)
    s[:len(c)] = c
    valid = np.arange(capacity) < len(c)
    return (torch.as_tensor(s, device=dev),
            torch.as_tensor(valid, device=dev))


def _lm_fit_shapes(torch, corrected, truth_centers, peaks, smi: str) -> dict:
    """lm_fit against its plain version and timed at every launch shape the
    paths make, each over three fresh inputs with seeds at the planted
    centres (so no seeding kernel is needed): slice 1's round 0 (2048 seeds,
    P = 512, 8 iterations) and its Jacobi refit (512 spots); the e2e path's
    round 0 (4096 seeds, channel 0 of rounds 0-2) and refit (1024); the
    calibration fit (512 bead seeds, 30 iterations; the two bead targets
    and the reference image) and its refit (128 spots, 10 iterations); and
    P = 254 (r = 4) and P = 922 (r = 6) on the bench scene.  Each shape:
    the checks of _check_lm on every input, kernel and plain CUDA-event
    medians, the bound."""
    from imageanalysis3_tpu_torch import synthetic as syn

    dev = corrected[0].device
    bench = [(im, *_planted_seeds(torch, truth_centers, 2048, dev))
             for im in corrected]
    e2e = syn.make_e2e_scene()
    e2e_in = []
    for r in range(3):
        b = r * e2e.n_data_ch
        centers = np.vstack([e2e.bit_spots[b], e2e.distractors[(r, 0)]]) \
            + e2e.drifts[r]
        im = e2e.round_stack(r, dev)[0].to(torch.float32)
        e2e_in.append((im, *_planted_seeds(torch, centers, 4096, dev)))
    cal = syn.make_calibration_scene()
    beads = cal.beads["centers"]
    cal_in = []
    for ci in (0, 2):
        tar, ref = cal.bead_pair(ci, dev)
        cal_in.append((tar.to(torch.float32),
                       *_planted_seeds(torch, cal.shifted(ci, beads), 512,
                                       dev)))
    cal_in.append((ref.to(torch.float32),
                   *_planted_seeds(torch, beads, 512, dev)))
    del tar, ref
    cases = [("slice1 round 0", bench, 5, 8, True),
             ("e2e round 0", e2e_in, 5, 8, True),
             ("calibration round 0", cal_in, 5, 30, True),
             ("r4", bench, 4, 8, False), ("r6", bench, 6, 8, False)]
    out = {}
    for name, sets, radius, iters, refit in cases:
        out.update(_lm_time_case(torch, name, sets, radius, iters, refit,
                                 peaks, smi))
    return out


def _lm_time_case(torch, name, sets, radius, iters, refit, peaks,
                  smi: str) -> dict:
    """lm_fit against its plain version and timed at one launch shape (and
    its Jacobi refit's when `refit`): `sets` are (stack, seeds, valid)
    inputs, each gathered and masked as iter_fit_seed_points' round 0
    does; the checks of _check_lm on every input, kernel and plain
    CUDA-event medians, the bound."""
    from imageanalysis3_tpu_torch.ops import lm_kernel

    r0s = [_lm_round0(torch, im, s, v, radius, iters) for im, s, v in sets]
    shape = tuple(sets[0][0].shape)
    batches = {name: ([r["lm_in"] for r in r0s],
                      [(r["svalid"], r["base"]) for r in r0s])}
    if refit:
        ref_in, ref_ok = [], []
        for r in r0s:
            pp, ep = lm_kernel.lm_fit_plain(*r["lm_in"])
            lm_in, sel = _lm_refit(torch, r, pp, ep)
            ref_in.append(lm_in)
            ref_ok.append((r["svalid"][sel], r["base"][sel]))
        batches[name.replace("round 0", "refit")] = (ref_in, ref_ok)
    out = {}
    for label, (inputs, oks) in batches.items():
        err, n_valid, decided = 0.0, [], []
        for lm_in, (sv, base) in zip(inputs, oks):
            e, nv, _, dec = _check_lm(torch, label, lm_in, sv, base, shape)
            err, n_valid = max(err, e), n_valid + [nv]
            decided.append(dec)
        ms = _events_ms(torch, lm_kernel.lm_fit_cuda, inputs,
                        queue_ahead=True)
        plain_ms = _events_ms(torch, lm_kernel.lm_fit_plain, inputs,
                              queue_ahead=False)
        n, p = inputs[0][0].shape
        it = inputs[0][8]
        bound = _lm_bound(n, p, it, peaks)
        out[label] = {"spots": n, "px": p, "iters": it,
                      "n_valid": n_valid, "order_decided": decided,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"lm_fit {label}: PASS  {n} spots x {p} px x {it} iters, "
              f"valid {n_valid}, decided by the summation order "
              f"{decided}, max |dcentre| {err:.3g} px; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x)"
              f"  [{smi}]")
    return out


def _lm_fit_report(torch, smi: str) -> dict:
    """lm_fit's ptxas registers and spills and the resident blocks (spots)
    and warps per SM the card grants at each pixel count the paths use."""
    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch.ops import lm_kernel

    ptxas = _ptxas_report(_build.build_logs.get("lm_fit", ""))
    occ = {}
    for p in (120, 254, 512, 922):
        blocks, threads, smem = lm_kernel.lm_occupancy_cuda(p)
        occ[p] = {"blocks_per_sm": blocks, "threads": threads,
                  "smem_bytes": smem, "warps_per_sm": blocks * threads // 32}
    for line in ptxas:
        print(f"  ptxas lm_fit: {line}")
    print("  occupancy lm_fit: " + ", ".join(
        f"P={p}: {o['threads']} threads, {o['smem_bytes']} B dynamic shared "
        f"memory a spot, {o['blocks_per_sm']} spots = {o['warps_per_sm']} "
        f"warps per SM" for p, o in occ.items()) + f"  [{smi}]")
    return {"ptxas": ptxas, "occupancy": occ}


#: a spot's fit depends on the summation order when another order of its
#: pixels moves its centre more than this (px): 4 float32 ulps at
#: 1024-2048 px, where a well-conditioned fit moves by at most 1
LM_ORDER_SENSITIVE = 5e-4
#: the most spots of an e2e-path batch (in 1000, and 2) whose fit the
#: order may decide under that rule: 0-1 a batch of ~1000-1500 on the
#: path's seeds (PERF.md §6)
LM_ORDER_CAP = 5


def _lm_order_phase(torch, smi: str, rounds: int = 3) -> dict:
    """The lm_fit kernel on the e2e path's own seeds, under the summation
    order's rule: each data channel of ``make_e2e_scene()``'s first
    `rounds` rounds, corrected and seeded by the exact classifier as
    phase 5 runs them, gathered as round 0 builds its LM batch and as the
    first Jacobi round builds its refit batch; each batch under
    `_check_lm` with a spot decided by the order when another order of
    its pixels moves its plain fit beyond LM_ORDER_SENSITIVE, at most
    LM_ORDER_CAP in 1000 of the valid spots (and 2) so decided, every
    other spot held to the kernel's tolerances (centres 1e-3 px).  On
    this scene single ill-conditioned fits (blends of close spots) move
    up to ~0.7 px with the order alone, the kernel's like the plain
    version's (PERF.md §6); this gate holds the kernel to moving
    no other spot."""
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.ops import lm_kernel
    from imageanalysis3_tpu_torch.ops.seeding import get_seeds
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    t0 = time.perf_counter()
    scene = syn.make_e2e_scene()
    n_data = scene.n_data_ch
    cfg = ExperimentConfig(
        image_size=scene.shape,
        seed=SeedConfig(th_seed=300.0, max_num_seeds=4096, pyramid_bg=False),
        fit=FitConfig())
    pipe = FovPipeline(cfg, n_channels=n_data + 1, drift_channel_index=n_data,
                       fit_channel_indices=tuple(range(n_data)),
                       image_shape=scene.shape)
    s, f = cfg.seed, cfg.fit
    batches = []
    for r in range(rounds):
        ims = scene.round_stack(r)
        for ci in range(n_data):
            im = pipe.correct_one(ims[ci], ci)
            seeds = get_seeds(
                im, max_num_seeds=s.max_num_seeds,
                th_seed=float(pipe.seed_thresholds[ci]),
                gfilt_size=s.gfilt_size,
                background_gfilt_size=s.background_gfilt_size,
                filt_size=s.filt_size, min_edge_distance=s.min_edge_distance,
                use_dynamic_th=s.use_dynamic_th,
                dynamic_niters=s.dynamic_niters,
                min_dynamic_seeds=s.min_dynamic_seeds,
                cand_capacity=s.cand_capacity, pyramid_bg=s.pyramid_bg)
            r0 = _lm_round0(torch, im, seeds.coords.to(torch.float32),
                            seeds.valid, f.radius, f.lm_iters)
            pp, ep = lm_kernel.lm_fit_plain(*r0["lm_in"])
            lm_in, sel = _lm_refit(torch, r0, pp, ep)
            for label, args in (
                    ("round 0", (r0["lm_in"], r0["svalid"], r0["base"])),
                    ("refit", (lm_in, r0["svalid"][sel], r0["base"][sel]))):
                n_valid = int(args[1].sum())
                err, _, _, decided = _check_lm(
                    torch, f"e2e path r{r} c{ci} {label}", *args,
                    tuple(im.shape), order_px=LM_ORDER_SENSITIVE,
                    cap=max(2, n_valid * LM_ORDER_CAP // 1000))
                batches.append({"round": r, "channel": ci, "batch": label,
                                "valid": n_valid, "decided": decided,
                                "max_abs_err": err})
            del im, seeds, r0, lm_in
        del ims
    most = max(len(b["decided"]) / max(b["valid"], 1) for b in batches)
    print(f"lm order: PASS  {len(batches)} e2e-path batches ({rounds} rounds "
          f"x {n_data} channels, round 0 and refit); decided by the order "
          f"(another order moves the plain fit > {LM_ORDER_SENSITIVE} px) "
          f"{[len(b['decided']) for b in batches]} of "
          f"{[b['valid'] for b in batches]} valid (most {1000 * most:.2f} "
          f"in 1000, cap {LM_ORDER_CAP}); held spots' max |dcentre| "
          f"{max(b['max_abs_err'] for b in batches):.3g} px  [{smi}]",
          flush=True)
    return {"batches": batches, "seconds": time.perf_counter() - t0}


def _calibration_phase(torch, smi: str) -> dict:
    """The bead-calibration path at full width (60x2048x2048 stacks rendered
    on the card from fixed seeds; rendering timed apart from each stage):
    (a) ``IlluminationProfiler`` (smooth_sigma 60) over 4 flat-field stacks
    under the planted vignette (falloff 0.35), each streamed alone: mean
    |error| of the normalised interior (128-px border dropped) < 0.05, and
    no kernel launched; (b) ``generate_bleed_profile_from_rounds`` on 3
    single-label rounds under ``bleed_matrix(3, 0.08)``: after
    ``bleedthrough_unmix`` the leak of the 20 brightest labelled spots into
    each neighbouring channel < 0.25x the leak before; (c)
    ``generate_chromatic_constants(max_num_seeds=512)`` on the 500-bead
    pair of each non-reference channel under its planted order-2 shift:
    n_pairs >= 50 % of the beads and the planted target beads, corrected by
    ``warp_spot_coords``, within a median 0.1 px of the truth; (d) the
    profiles saved with ``save_correction_profile`` into a temporary
    folder, loaded back, a ``FovPipeline`` (bleedthrough on, exact
    classifier) built from them, and one 3-channel round under the same
    optics with drift 0: each channel's corrected spots, over the truths
    matched within 1 px, within a median 0.1 px.  seed_classify, lm_fit and
    gather_cubes must launch in (b)-(d)."""
    import tempfile

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CORR_CHANNELS,
                                                 CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.io import (load_correction_profile,
                                             save_correction_profile)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops.corrections import bleedthrough_unmix
    from imageanalysis3_tpu_torch.ops.profiles import (
        IlluminationProfiler, generate_bleed_profile_from_rounds,
        generate_chromatic_constants, invert_mixing_profile)
    from imageanalysis3_tpu_torch.ops.warp import warp_spot_coords
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sync()
    rec = {"earlier_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    scene = syn.make_calibration_scene()
    shape, ref_ci = scene.shape, scene.ref_channel
    chans = tuple(CORR_CHANNELS)
    rec.update(shape=shape, seconds={}, render_seconds={}, launches={})

    def render(stage, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        rec["render_seconds"][stage] = time.perf_counter() - t0
        return out

    def run(stage, fn):
        sync()
        reset_kernel_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        rec["seconds"][stage] = time.perf_counter() - t0
        rec["launches"][stage] = counts = kernel_launches()
        return out, counts

    def need(stage, counts, **least):
        """At least `least` launches of each kernel."""
        for name, n in least.items():
            if counts[name] < n:
                raise AssertionError(f"calibration ({stage}): {name} launched "
                                     f"{counts[name]} < {n} times: {counts}")

    # (a) illumination
    stacks = render("illumination", lambda: [
        scene.illumination_stack(k, dev)
        for k in range(len(scene.illum_spots))])

    def profile():
        prof = IlluminationProfiler(shape[1:], device=dev, smooth_sigma=60.0)
        while stacks:
            prof.add_stack(stacks.pop(0))
        return prof.finalize()

    illum, counts = run("illumination", profile)
    if any(counts.values()):
        raise AssertionError(f"calibration (a): kernels launched {counts}")
    b = 128                                 # the border the gate drops
    got = illum[b:-b, b:-b] / illum[b:-b, b:-b].max()
    want = scene.illumination[b:-b, b:-b] / scene.illumination[b:-b, b:-b].max()
    rec["illumination_interior_err"] = ill_err = float(np.abs(got - want)
                                                       .mean())
    if not ill_err < 0.05:
        raise AssertionError(f"calibration (a): interior error {ill_err}")

    # (b) bleedthrough
    rounds = render("bleed", lambda: [scene.bleed_round(i, dev)
                                      for i in range(3)])
    bleed, counts = run("bleed", lambda: generate_bleed_profile_from_rounds(
        rounds))
    need("b", counts, seed_classify=3, lm_fit=3, gather_cubes=15)
    prof_t = torch.as_tensor(bleed, device=dev)
    # the stage's batched (X*Y) 3x3 inverse on its own, warm
    sync()
    t0 = time.perf_counter()
    invert_mixing_profile(prof_t)
    sync()
    rec["bleed_inverse_seconds"] = time.perf_counter() - t0
    leaks = {}
    for i, raw in enumerate(rounds):
        obs = raw.to(torch.float32)
        unmixed = bleedthrough_unmix(obs, prof_t)
        t = scene.bleed_spots[i]
        top = np.argsort(-t["heights"])[:20]
        p = np.rint(scene.shifted(i, t["centers"][top])).astype(np.int64)
        pz, px_, py = (torch.as_tensor(p[:, k], device=dev) for k in range(3))
        for c in range(3):
            if c == i or scene.mixing[c, i] == 0:
                continue
            before = obs[c][pz, px_, py] - obs[c][:, ::16, ::16].median()
            after = unmixed[c][pz, px_, py] \
                - unmixed[c][:, ::16, ::16].median()
            leaks[f"{i}->{c}"] = (float(before.abs().median()),
                                  float(after.abs().median()))
        del obs, unmixed
    del rounds
    rec["leak_before_after"] = leaks
    for key, (before, after) in leaks.items():
        if not after < 0.25 * before:
            raise AssertionError(f"calibration (b): leak {key} {after} after "
                                 f"unmixing, {before} before")
    centre = np.linalg.inv(bleed[:, :, shape[1] // 2, shape[2] // 2])
    rec["mixing_at_centre"] = centre.tolist()

    # (c) chromatic constants, one bead pair per non-reference channel
    constants, n_pairs, bead_errs = {}, {}, {}
    beads = scene.beads["centers"]
    for ci in range(3):
        if ci == ref_ci:
            continue
        tar, ref = render(f"chromatic_{chans[ci]}",
                          lambda: scene.bead_pair(ci, dev))
        (const, n), counts = run(
            f"chromatic_{chans[ci]}",
            lambda: generate_chromatic_constants(
                tar, ref, max_num_seeds=512))
        del tar, ref
        need(f"c, {chans[ci]}", counts, seed_classify=2, lm_fit=2,
             gather_cubes=2)
        corrected = warp_spot_coords(
            torch.as_tensor(scene.shifted(ci, beads), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(const, device=dev),
            torch.as_tensor(scene.ref_center, dtype=torch.float32,
                            device=dev),
            torch.zeros(3, device=dev)).cpu().numpy()
        err = float(np.median(np.linalg.norm(corrected - beads, axis=1)))
        constants[chans[ci]], n_pairs[chans[ci]] = const, n
        bead_errs[chans[ci]] = err
        if n < 0.5 * len(beads):
            raise AssertionError(f"calibration (c), {chans[ci]}: {n} pairs of "
                                 f"{len(beads)} beads")
        if not err < 0.1:
            raise AssertionError(f"calibration (c), {chans[ci]}: median "
                                 f"corrected bead error {err} px")
    rec.update(n_pairs=n_pairs, n_beads=len(beads),
               bead_median_err_px=bead_errs)

    # (d) profiles through files into FovPipeline, one corrected round
    raw = render("round", lambda: scene.round_stack(dev))
    cfg = ExperimentConfig(
        image_size=shape, correction=CorrectionConfig(bleedthrough=True),
        seed=SeedConfig(th_seed=300.0, max_num_seeds=2048, pyramid_bg=False),
        fit=FitConfig())

    def through_files():
        """The three profiles saved and loaded back under the reference's
        file names."""
        with tempfile.TemporaryDirectory() as folder:
            kw = dict(corr_channels=chans, ref_channel=chans[ref_ci],
                      im_size=shape)
            save_correction_profile("illumination",
                                    {c: illum for c in chans}, folder, **kw)
            save_correction_profile("bleedthrough", bleed, folder, **kw)
            save_correction_profile("chromatic_constants", constants, folder,
                                    **kw)
            return (load_correction_profile("illumination", folder, **kw),
                    load_correction_profile("bleedthrough", folder, **kw),
                    load_correction_profile("chromatic_constants", folder,
                                            **kw))

    (ill, bleed_f, consts), _ = run("files", through_files)

    def corrected_round():
        pipe = FovPipeline(
            cfg, n_channels=3, drift_channel_index=ref_ci,
            fit_channel_indices=(0, 1, 2),
            illumination=np.stack([ill[c] for c in chans]), bleed=bleed_f,
            chromatic_constants=np.stack([
                np.zeros((3, 10), np.float32) if consts[c] is None
                else consts[c] for c in chans]),
            image_shape=shape, device=dev)
        ref_im = pipe.prepare_reference(pipe.correct_reference(raw))
        return pipe.process_round(raw, ref_im)

    res, counts = run("round", corrected_round)
    need("d", counts, seed_classify=3, lm_fit=3, gather_cubes=3)
    spot_errs = {}
    for ci in range(3):
        got = res.spots[ci][res.valid[ci]][:, 1:4].cpu().numpy()
        truth = scene.round_spots[ci]["centers"]
        d = np.linalg.norm(truth[:, None] - got[None], axis=-1).min(axis=1)
        matched = d[d < 1.0]
        med = float(np.median(matched)) if len(matched) else float("nan")
        spot_errs[chans[ci]] = {"median_err_px": med,
                                "matched": int(len(matched)),
                                "planted": int(len(truth)),
                                "n_valid": int(res.valid[ci].sum())}
        if not med <= 0.1:
            raise AssertionError(f"calibration (d), {chans[ci]}: median spot "
                                 f"error {med} px")
    rec["round_spots"] = spot_errs
    rec["drift"] = res.drift.cpu().numpy().tolist()
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["total_launches"] = {k: sum(c[k] for c in rec["launches"].values())
                             for k in kernel_launches()}
    print(f"calibration (a) illumination: {rec['seconds']['illumination']:.3f}"
          f" s for {len(scene.illum_spots)} stacks, interior error "
          f"{ill_err:.5f}, launches {rec['launches']['illumination']}")
    print(f"calibration (b) bleed: {rec['seconds']['bleed']:.3f} s (its "
          f"batched inverse alone {rec['bleed_inverse_seconds']:.3f} s), leak "
          f"before/after {leaks}; mixing at the FOV centre "
          f"{np.round(centre, 4).tolist()} (planted off-diagonal 0.08)")
    print(f"calibration (c) chromatic: "
          f"{ {k: round(v, 3) for k, v in rec['seconds'].items() if k.startswith('chromatic')} } s, "
          f"n_pairs {n_pairs} of {len(beads)} beads, median corrected bead "
          f"error {bead_errs} px")
    print(f"calibration (d) profile files {rec['seconds']['files']:.3f} s, "
          f"FovPipeline round {rec['seconds']['round']:.3f} s, spots "
          f"{spot_errs}, drift "
          f"{rec['drift']}; render {rec['render_seconds']} s; peak device "
          f"memory {rec['peak_memory_bytes'] / 2 ** 30:.2f} GiB; launches "
          f"{rec['total_launches']}  [{smi}]")
    return rec


#: the on-disk path's movies: bench.py's geometry in 3 channels (2 data
#: channels, beads last), interleaved after 10 buffer frames
DAX_CHANNELS = ("750", "647", "488")
DAX_BUFFER = 10
#: H1's content moves by this much against H0's (px, zxy)
DAX_SHIFT = (0.6, -1.4, 2.3)
#: the kernels the on-disk path runs
DAX_PATH = ("seed_classify", "seed_pyramid", "lm_fit", "gather_cubes")


def _matched_errors(torch, got, truth):
    """Distance of each planted centre to its nearest fitted one, over the
    centres matched within 1 px (bench.py's rule)."""
    if not len(got):
        return np.zeros(0), 0
    d = torch.cdist(torch.as_tensor(np.asarray(truth, np.float32),
                                    device=got.device).double(),
                    got.double()).min(dim=1).values.cpu().numpy()
    return d[d < 1.0], int((d < 1.0).sum())


def _cold(path):
    """Drop the file's clean pages from the page cache (POSIX_FADV_DONTNEED)
    so the next read comes from the disk where the kernel honours it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _dax_phase(torch, smi: str) -> dict:
    """The on-disk .dax path at bench.py's geometry: two rounds H0, H1 of
    60x2048x2048 uint16 in 3 channels (750 and 647 with 1800 planted spots
    each under a vignette (falloff 0.35), 750 also under order-2 chromatic
    shifts up to ~2 px at the edge; 488 with 500 beads), H1's content moved
    by DAX_SHIFT, rendered on the card, interleaved after 10 buffer frames
    and written by ``io.write_dax`` (~1.6 GB a movie) into a directory of
    the checkout's build/, removed at the end.  Gates, each a hard
    failure: (1) ``load_dax_channels`` (native, built), ``read_dax`` +
    ``split_channels`` and ``read_raw_window`` + ``deinterleave_stack`` on
    the card equal the written stacks bit for bit; (2) ``warp_image`` by a
    drift alone (with fractions exact in f32 at every coordinate) equals
    ``warp_image_drift`` and the 8-tap ``trilinear_map_coordinates`` at the
    shifted grid (rtol 1e-5, atol 1e-2); (3) ``DaxProcesser`` on H1: load, hot pixels, illumination,
    drift against H0's corrected beads within 0.1 px of the planted drift
    per axis with flag 0; (a) fits of the unwarped data channels corrected
    by ``_correct_spot_coords`` and (b) fits after ``_warp_image`` with the
    chromatic constants each match >= 90 % of the planted spots within 1
    px, at a median error in H0's frame <= 0.05 px (a) and <= 0.1 px (b);
    seed_classify, gather_cubes and lm_fit launch; (4)
    ``FovPipeline.process_round_raw`` on H1's raw frame window equals
    ``process_round`` on the loader's stacks and ``process_rounds`` on (H0,
    H1) equals the two ``process_round`` calls (``torch.equal`` on every
    field); seed_pyramid launches.  Every step is timed on the host clock
    around ``torch.cuda.synchronize()``, the ``DaxProcesser`` steps after
    one untimed pass of the same steps over H0."""
    import shutil
    import tempfile

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.io import (interleave_channels,
                                             load_dax_channels,
                                             native_loader_available,
                                             raw_frame_window, read_dax,
                                             read_raw_window, split_channels,
                                             write_dax)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops.corrections import deinterleave_stack
    from imageanalysis3_tpu_torch.ops.warp import (monomial_exponents,
                                                   trilinear_map_coordinates,
                                                   warp_image,
                                                   warp_image_drift)
    from imageanalysis3_tpu_torch.pipeline import DaxProcesser, FovPipeline

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    if not native_loader_available():
        raise AssertionError("dax path: the native loader did not build")
    shape, chans, n_z = SHAPE, list(DAX_CHANNELS), SHAPE[0]
    stack_bytes = int(np.prod(shape)) * 2
    movie_bytes = (n_z * len(chans) + 2 * DAX_BUFFER) * stack_bytes // n_z
    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 3 * movie_bytes:
        raise AssertionError(f"dax path: {free / 1e9:.2f} GB free under "
                             f"{root}, need {3 * movie_bytes / 1e9:.2f}")
    rec = {"shape": shape, "channels": chans, "movie_bytes": movie_bytes,
           "seconds": {}, "launches": {}}
    secs = rec["seconds"]

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # ---- the scene -------------------------------------------------------
    rng = np.random.default_rng(21)
    spots = [syn.sample_spot_params(shape, N_SPOTS, rng, min_separation=8.0,
                                    height_range=(400.0, 3000.0),
                                    sigma_jitter=0.0) for _ in range(2)]
    beads = syn.sample_spot_params(shape, 500, rng, min_separation=14.0,
                                   height_range=(2000.0, 5000.0),
                                   sigma_jitter=0.0, background=120.0)
    vig = syn.illumination_profile(shape[1:], falloff=0.35)
    vig_t = torch.as_tensor(vig.astype(np.float32), device=dev)
    half = np.asarray(shape, np.float64) / 2.0
    scale = np.array([1.0 / np.prod(half ** np.asarray(e))
                      for e in monomial_exponents(3, 2)])
    consts = (np.asarray(syn.PLANTED_SHIFTS[0]) * scale[None]
              ).astype(np.float32)
    chrom = {"750": consts}
    shift = np.asarray(DAX_SHIFT)

    def imaged(ci, centers):
        """Where channel ci images the sample points `centers`."""
        if ci == 0:
            return centers + syn._poly_shift_np(centers, consts, half)
        return centers

    tmp = tempfile.mkdtemp(prefix="dax_path_", dir=root)
    try:
        paths, stacks_np = [], []
        for r, d in enumerate((np.zeros(3), shift)):
            t0 = time.perf_counter()
            chs = []
            for ci, t in enumerate(spots):
                im = syn.render_spots(shape, imaged(ci, t["centers"] + d),
                                      t["heights"], background=150.0,
                                      device=dev)
                chs.append(syn.noisy_uint16(im, seed=40 + 10 * r + ci,
                                            illumination=vig_t))
                del im
            im = syn.render_spots(shape, beads["centers"] + d,
                                  beads["heights"], background=120.0,
                                  device=dev)
            chs.append(syn.noisy_uint16(im, seed=42 + 10 * r))
            del im
            host = [c.cpu().numpy() for c in chs]
            del chs
            movie = interleave_channels(host, buffer_frames=DAX_BUFFER)
            secs[f"render_H{r}"] = time.perf_counter() - t0
            path = os.path.join(tmp, f"H{r}", "Conv_zscan_00.dax")
            os.makedirs(os.path.dirname(path))

            def write():
                write_dax(path, movie)
                with open(path, "rb+") as fh:
                    os.fsync(fh.fileno())
            timed(f"write_H{r}", write)
            del movie
            paths.append(path)
            stacks_np.append(np.stack(host))
            del host
        rec["write_GBps"] = movie_bytes / secs["write_H1"] / 1e9

        # ---- 1. reads ---------------------------------------------------
        want = stacks_np[1]
        kw = dict(n_z=n_z, buffer_frames=DAX_BUFFER)
        _cold(paths[1])
        block = timed("read_native_cold", lambda: load_dax_channels(
            paths[1], chans, chans, **kw))
        if not np.array_equal(block, want):
            raise AssertionError("dax path: load_dax_channels differs from "
                                 "the written stacks")
        block = timed("read_native_warm", lambda: load_dax_channels(
            paths[1], chans, chans, **kw))
        # into the same staging block again: no fresh pages to fault in
        block = timed("read_native_reused", lambda: load_dax_channels(
            paths[1], chans, chans, out=block, **kw))
        if not np.array_equal(block, want):
            raise AssertionError("dax path: load_dax_channels into a reused "
                                 "block differs from the written stacks")
        _cold(paths[1])

        def numpy_read():
            movie, _ = read_dax(paths[1], memmap=False)
            return split_channels(movie, chans, chans, **kw)
        split = timed("read_numpy_cold", numpy_read)
        if not all(np.array_equal(a, b) for a, b in zip(split, want)):
            raise AssertionError("dax path: read_dax + split_channels "
                                 "differs from the written stacks")
        del split
        win = raw_frame_window(chans, chans, **kw)
        _cold(paths[1])
        raw = timed("read_raw_window_cold",
                    lambda: read_raw_window(paths[1], win))
        dein = timed("upload_deinterleave", lambda: deinterleave_stack(
            torch.as_tensor(raw, device=dev), win.rel_starts, win.n_colors,
            n_z))
        if not torch.equal(dein, torch.as_tensor(want, device=dev)):
            raise AssertionError("dax path: read_raw_window + "
                                 "deinterleave_stack differs from the "
                                 "written stacks")
        del dein
        rec["read_GBps"] = {
            k: (3 * stack_bytes if k != "read_raw_window_cold"
                else raw.nbytes) / secs[k] / 1e9
            for k in ("read_native_cold", "read_native_warm",
                      "read_native_reused", "read_numpy_cold",
                      "read_raw_window_cold")}
        print(f"dax path: write {secs['write_H1']:.3f} s "
              f"({rec['write_GBps']:.2f} GB/s for {movie_bytes / 1e9:.3f} "
              f"GB); reads "
              f"{ {k: round(secs[k], 4) for k in rec['read_GBps']} } s, "
              f"{ {k: round(v, 3) for k, v in rec['read_GBps'].items()} } "
              f"GB/s; upload + deinterleave "
              f"{secs['upload_deinterleave']:.4f} s; all equal to the "
              f"written stacks  [{smi}]")

        # ---- 2. warps at full size ---------------------------------------
        # the gate's drift has fractions exact in f32 at every coordinate
        # of the stack, so the 8-tap gather's weights (taken from the
        # shifted coordinate, ~2e3 px) equal the per-axis ones (taken from
        # the drift); at the planted drift the gather's coordinates carry
        # f32 rounding of up to 1.2e-4 px, which is reported
        im = torch.as_tensor(want[1], device=dev).to(torch.float32)
        d_gate = torch.tensor([-0.625, 1.375, -2.25])
        d = torch.tensor([-v for v in DAX_SHIFT], dtype=torch.float32)
        ax = [torch.arange(n, dtype=torch.float32, device=dev)
              for n in shape]

        def gather_diff(warped, dd, gate):
            worst = 0.0
            for z0 in range(0, n_z, 6):
                grid = torch.stack(torch.meshgrid(
                    ax[0][z0:z0 + 6] - float(dd[0]), ax[1] - float(dd[1]),
                    ax[2] - float(dd[2]), indexing="ij"))
                ref = trilinear_map_coordinates(im, grid)
                diff = (warped[z0:z0 + 6] - ref).abs()
                worst = max(worst, float(diff.max()))
                if gate and bool((diff > 1e-2 + 1e-5 * ref.abs()).any()):
                    raise AssertionError(
                        f"dax path: warp_image by {dd.tolist()} differs "
                        f"from the 8-tap gather beyond rtol 1e-5 / atol "
                        f"1e-2 at planes {z0}+ (max |diff| {worst})")
                del grid, ref, diff
            return worst

        warped = warp_image(im, d_gate)
        if not torch.equal(warped, warp_image_drift(im, d_gate)):
            raise AssertionError("dax path: warp_image(im, d) differs from "
                                 "warp_image_drift")
        rec["warp_max_abs_err"] = gather_diff(warped, d_gate, True)
        warped = timed("warp_image_drift", lambda: warp_image(im, d))
        rec["warp_max_abs_err_planted"] = gather_diff(warped, d, False)
        timed("warp_image_chromatic", lambda: warp_image(
            im, d, consts, half.astype(np.float32)))
        print(f"dax path: warp_image by {d_gate.tolist()} equal to "
              f"warp_image_drift and within rtol 1e-5 / atol 1e-2 of the "
              f"8-tap gather (max |diff| {rec['warp_max_abs_err']:.3g}); "
              f"at the planted drift max |diff| "
              f"{rec['warp_max_abs_err_planted']:.3g} (the gather's f32 "
              f"coordinates); warp_image (drift) "
              f"{secs['warp_image_drift']:.4f} s, with order-2 chromatic "
              f"constants {secs['warp_image_chromatic']:.4f} s  [{smi}]")
        del im, warped

        # ---- 3. DaxProcesser on H1 ---------------------------------------
        proc_kw = dict(all_channels=chans, single_im_size=shape,
                       num_buffer_frames=DAX_BUFFER)
        ref_proc = DaxProcesser(paths[0], correction_channels=["488"],
                                **proc_kw)
        ref_proc._load_image()._corr_hot_pixels_3D()
        ref_beads = ref_proc.ims["488"]
        del ref_proc
        fit_kw = dict(th_seed=TH_SEED, max_num_seeds=2048)
        data = ["750", "647"]
        # one untimed pass over H0 takes every step's first-call costs
        # (cuFFT plans, the allocator's growth, first kernel launches)
        warm = DaxProcesser(paths[0], **proc_kw)
        warm._load_image()._corr_hot_pixels_3D()._corr_illumination(
            {"750": vig, "647": vig})
        warm._calculate_drift(ref_beads, drift_channel="488")
        warm._fit_spots(channels=data, **fit_kw)
        warm._warp_image(channels=data, chromatic_constants=chrom)
        del warm
        proc = DaxProcesser(paths[1], **proc_kw)
        timed("step_load_image", proc._load_image)
        timed("step_hot_pixels", proc._corr_hot_pixels_3D)
        timed("step_illumination", lambda: proc._corr_illumination(
            {"750": vig, "647": vig}))
        drift = timed("step_calculate_drift", lambda: proc._calculate_drift(
            ref_beads, drift_channel="488")).cpu().numpy()
        del ref_beads
        rec["drift"], rec["drift_flag"] = drift.tolist(), proc.drift_flag
        derr = np.abs(drift + shift)
        print(f"dax path: drift {drift.round(4).tolist()} flag "
              f"{proc.drift_flag} (planted {(-shift).tolist()}, |error| "
              f"{derr.round(4).tolist()} px)")
        if derr.max() > 0.1 or proc.drift_flag != 0:
            raise AssertionError(f"dax path: drift {drift} (flag "
                                 f"{proc.drift_flag}) vs planted {-shift}")
        rec["accuracy"] = {}

        def check(label, fits, coords_of, limit):
            out = {}
            for ci, ch in enumerate(data):
                res = fits[ch]
                got = coords_of(ch, res.spots[res.valid][:, 1:4])
                errs, n_m = _matched_errors(torch, got, spots[ci]["centers"])
                med = float(np.median(errs)) if len(errs) else float("nan")
                out[ch] = {"median_err_px": med, "matched": n_m,
                           "n_valid": int(res.valid.sum())}
            rec["accuracy"][label] = out
            print(f"dax path ({label}): {out}")
            for ch, o in out.items():
                if o["matched"] < 0.9 * N_SPOTS or \
                        not o["median_err_px"] <= limit:
                    raise AssertionError(
                        f"dax path ({label}), {ch}: {o['matched']} of "
                        f"{N_SPOTS} matched, median error "
                        f"{o['median_err_px']} px (limit {limit})")

        reset_kernel_launches()
        fits = timed("step_fit_spots", lambda: proc._fit_spots(
            channels=data, **fit_kw))
        rec["launches"]["fit_unwarped"] = kernel_launches()
        check("a: coordinates", fits,
              lambda ch, c: proc._correct_spot_coords(c, ch, chrom), 0.05)
        timed("step_warp_image", lambda: proc._warp_image(
            channels=data, chromatic_constants=chrom))
        reset_kernel_launches()
        fits = timed("step_fit_spots_warped", lambda: proc._fit_spots(
            channels=data, **fit_kw))
        rec["launches"]["fit_warped"] = counts = kernel_launches()
        check("b: image warp", fits, lambda ch, c: c, 0.1)
        for name in ("seed_classify", "gather_cubes", "lm_fit"):
            if min(rec["launches"][k][name]
                   for k in ("fit_unwarped", "fit_warped")) < 1:
                raise AssertionError(f"dax path: {name} did not launch in "
                                     f"the DaxProcesser fits: "
                                     f"{rec['launches']}")
        del proc, fits

        # ---- 4. the round entries ----------------------------------------
        cfg = ExperimentConfig(
            image_size=shape, correction=CorrectionConfig(),
            seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048),
            fit=FitConfig())
        chrom3 = np.zeros((3, 3, 10), np.float32)
        chrom3[0] = consts
        pipe = FovPipeline(cfg, n_channels=3, drift_channel_index=2,
                           fit_channel_indices=(0, 1),
                           illumination=np.stack([vig, vig,
                                                  np.ones_like(vig)]),
                           chromatic_constants=chrom3, image_shape=shape)
        ref_spec = pipe.prepare_reference(pipe.correct_reference(
            load_dax_channels(paths[0], chans, chans, **kw)))
        block0 = load_dax_channels(paths[0], chans, chans, **kw)
        raw_t, direct_t = [], []
        pipe.process_round_raw(raw, ref_spec, win.rel_starts, win.n_colors)
        for k in range(3):
            reset_kernel_launches()
            res_raw = timed("round_raw", lambda: pipe.process_round_raw(
                raw, ref_spec, win.rel_starts, win.n_colors))
            raw_t.append(secs["round_raw"])
            rec["launches"]["process_round_raw"] = kernel_launches()
            res = timed("round", lambda: pipe.process_round(block,
                                                            ref_spec))
            direct_t.append(secs["round"])
        secs["round_raw"] = statistics.median(raw_t)
        secs["round"] = statistics.median(direct_t)
        for f in res._fields:
            if not torch.equal(getattr(res_raw, f), getattr(res, f)):
                raise AssertionError(f"dax path: process_round_raw.{f} "
                                     f"differs from process_round's")
        for name in ("seed_pyramid", "lm_fit", "gather_cubes"):
            if rec["launches"]["process_round_raw"][name] < 1:
                raise AssertionError(f"dax path: {name} did not launch in "
                                     f"process_round_raw: {rec['launches']}")
        rounds = {}
        for ci, ch in enumerate(data):
            errs, n_m = _matched_errors(
                torch, res.spots[ci][res.valid[ci]][:, 1:4],
                spots[ci]["centers"])
            rounds[ch] = {"median_err_px": float(np.median(errs)),
                          "matched": n_m}
        rec["round_accuracy"] = rounds
        res0 = pipe.process_round(block0, ref_spec)
        both = torch.stack([torch.as_tensor(b, device=dev)
                            for b in (block0, block)])
        del block0
        reset_kernel_launches()
        many = timed("process_rounds", lambda: pipe.process_rounds(
            both, ref_spec))
        rec["launches"]["process_rounds"] = kernel_launches()
        for r, one in enumerate((res0, res)):
            for f in one._fields:
                if not torch.equal(getattr(many, f)[r], getattr(one, f)):
                    raise AssertionError(f"dax path: process_rounds round "
                                         f"{r} {f} differs from "
                                         f"process_round's")
        del both, many, raw, block
        print(f"dax path: process_round_raw {secs['round_raw']:.4f} s/round "
              f"{[round(t, 4) for t in raw_t]}, process_round (loader "
              f"stacks) {secs['round']:.4f} s/round "
              f"{[round(t, 4) for t in direct_t]}, equal on every field; "
              f"process_rounds (H0, H1) {secs['process_rounds']:.4f} s, "
              f"equal to the two rounds; round spots {rounds}; drift "
              f"{res.drift.cpu().numpy().round(4).tolist()}  [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["total_launches"] = {k: sum(c[k] for c in rec["launches"].values())
                             for k in DAX_PATH}
    print(f"dax path: steps "
          f"{ {k: round(v, 4) for k, v in secs.items()} } s; launches "
          f"{rec['launches']}  [{smi}]")
    return rec


#: the experiment: 4 hyb rounds H0R0..H3R3 of the on-disk path's 3-channel
#: layout; each data channel carries one unique region a round (u1..u8)
EXP_ROUNDS = 4
#: spot heights of the experiment's regions: write_synthetic_experiment's
#: range, which the driver's per-channel seeding thresholds (the
#: reference's CHANNEL_SEED_THRESHOLDS: 750 -> 400, 647 -> 600) are set for
EXP_HEIGHTS = (1500.0, 5000.0)
#: the box nuclei of the chromosome step split the FOV at this x
EXP_SPLIT_X = SHAPE[1] // 2


def _store_rows(store, ids):
    """(ids, flags, drift flags, drifts, per-region (spots, drift, flag))
    of the 'unique' data type, through the store's public reads."""
    return {"ids": store.ids("unique"), "flags": store.flags("unique"),
            "drift_flags": store.drift_flags("unique"),
            "drifts": store.drifts("unique"),
            "rows": {rid: store.load_spots("unique", rid) for rid in ids}}


def _rows_equal(a, b) -> bool:
    """Every field of two `_store_rows` equal, by np.array_equal."""
    return all(np.array_equal(a[k], b[k])
               for k in ("ids", "flags", "drift_flags", "drifts")) and all(
        np.array_equal(x, y) for rid in a["rows"]
        for x, y in zip(a["rows"][rid], b["rows"][rid]))


def _tree_hashes(path) -> dict:
    """sha256 of the store at `path`: its file, or every file under it."""
    import hashlib
    files = [path] if os.path.isfile(path) else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]
    out = {}
    for p in files:
        with open(p, "rb") as fh:
            out[os.path.relpath(p, path)] = hashlib.sha256(
                fh.read()).hexdigest()
    return out


def _picks_agree(label, card, cpu, card_scores, cpu_scores) -> int:
    """How many picks differ between the card's run and the CPU's on one
    input; raises unless each differing pick's scores agree to 1e-5
    relative (an f32 tie the two devices broke apart)."""
    card, cpu = np.asarray(card), np.asarray(cpu)
    diff = card != cpu
    a = np.asarray(card_scores, np.float64)[diff]
    b = np.asarray(cpu_scores, np.float64)[diff]
    if not np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(a), np.abs(b))):
        raise AssertionError(
            f"{label}: {int(diff.sum())} picks differ between the card and "
            f"the CPU beyond an f32 tie: card {card[diff][:8]} scores "
            f"{a[:8]}, CPU {cpu[diff][:8]} scores {b[:8]}")
    return int(diff.sum())


def _field_of_view_step(torch, smi: str, timed, secs, data, save, cfg,
                        corr_folder, fov, centers) -> dict:
    """Phase 8, step 7: ``FieldOfView`` over the experiment's store.
    ``process_image_to_spots`` is a resume no-op (store byte-identical);
    the candidate table holds the 8 regions' ~1800 fitted spots each, so
    each DP step is an ~1800 x 1800 block; ``pick_spots("EM")`` without a
    centre and once per chromosome centre of step 5, ``pick_spots("naive")``
    and ``distance_map`` of the EM trace run on the card.  Gates: every EM
    pick equal to the port's CPU run on the same table, up to f32 ties
    (``_picks_agree``); the naive trace equal to the CPU's; the distance
    map within 1e-3 relative of a float64 NumPy pdist of the trace.  Every
    step is timed."""
    from imageanalysis3_tpu_torch.config import DEFAULT_PIXEL_SIZE_NM
    from imageanalysis3_tpu_torch.pipeline import FieldOfView

    dev = torch.device("cuda")
    view = FieldOfView(data, save, fov, cfg=cfg,
                       correction_folder=corr_folder, device=dev)
    before = _tree_hashes(view.store_path)
    counts = timed("fov_process_image_to_spots", view.process_image_to_spots)
    if counts != {"unique": 0} or _tree_hashes(view.store_path) != before:
        raise AssertionError(f"field of view: process_image_to_spots "
                             f"processed {counts} or changed the store")
    cand, valid, ids = timed("fov_candidate_table", view.candidate_table)
    out = {"table": list(cand.shape), "candidates": int(valid.sum()),
           "picks": {}}
    runs = [("em", None)] + [(f"em_centre{k}", c)
                             for k, c in enumerate(centers)]
    em = None
    for name, ctr in runs:
        res = timed(f"fov_pick_{name}", lambda: view.pick_spots(
            method="EM", chrom_center=ctr, device=dev))
        ref = timed(f"fov_pick_{name}_cpu", lambda: view.pick_spots(
            method="EM", chrom_center=ctr, device="cpu"))
        n_diff = _picks_agree(f"field of view {name}", res.sel_idx.cpu(),
                              ref.sel_idx, res.scores.cpu(), ref.scores)
        out["picks"][name] = {"n_iters": int(res.n_iters),
                              "picked": int(res.sel_valid.sum()),
                              "differ_from_cpu_at_ties": n_diff}
        if em is None:
            em = res
    naive = timed("fov_pick_naive", lambda: view.pick_spots(
        method="naive", device=dev))
    naive_cpu = view.pick_spots(method="naive", device="cpu")
    if not (torch.equal(naive.sel_idx.cpu(), naive_cpu.sel_idx)
            and torch.equal(naive.trace.cpu().nan_to_num(-1.0),
                            naive_cpu.trace.nan_to_num(-1.0))):
        raise AssertionError("field of view: the naive picks differ between "
                             "the card and the CPU")
    dm = timed("fov_distance_map", lambda: view.distance_map(em.trace,
                                                             device=dev))
    zxy = em.trace.cpu().numpy()[:, 1:4].astype(np.float64) * np.asarray(
        DEFAULT_PIXEL_SIZE_NM, np.float64)
    want = np.sqrt(((zxy[:, None] - zxy[None]) ** 2).sum(-1))
    if (dm.shape != want.shape or not np.array_equal(np.isnan(dm),
                                                     np.isnan(want))
            or not np.allclose(dm, want, rtol=1e-3, atol=0.0,
                               equal_nan=True)):
        raise AssertionError(f"field of view: distance map off a float64 "
                             f"pdist by {np.nanmax(np.abs(dm - want))} nm")
    out["distance_map_max_rel_err"] = float(np.nanmax(
        np.abs(dm - want) / np.maximum(want, 1e-30)))
    print(f"field of view: resume no-op, table {out['table']} "
          f"({out['candidates']} candidates), picks {out['picks']}, naive "
          f"equal to the CPU's, distance map max relative error "
          f"{out['distance_map_max_rel_err']:.2e}; seconds "
          f"{ {k: round(v, 4) for k, v in secs.items() if k.startswith('fov_')} }"
          f"  [{smi}]")
    return out


def _experiment_phase(torch, smi: str) -> dict:
    """A written experiment through ``ExperimentDriver`` at bench.py's
    geometry: EXP_ROUNDS hyb folders H0R0..H3R3 of 3-channel
    60x2048x2048 uint16 .dax movies (interleaved after 10 buffer frames,
    ~6.7 GB in all) and a Color_Usage.csv, in write_synthetic_experiment's
    layout, under a directory of the checkout's build/ (8 GB free space
    checked first, removed at the end).  750 and 647 carry one unique
    region each a round (u1..u8), each with its own 1800 spots under a
    vignette (falloff 0.35), 750 also under phase 7's order-2 chromatic
    shifts; 488 carries the same 500 beads every round.  H0 is undrifted,
    H1..H3 drifted by planted sub-pixel drifts of up to 2 px per axis.
    Both profiles reach the driver through a correction folder
    (``save_correction_profile``).  Gates, each a hard failure: (1)
    ``process_all`` (default input mode, async writes, the store backend
    the machine gives): every region flag 2, drift flag 0, drift within
    0.1 px per axis of the planted one, >= 90 % of its planted spots
    matched within 1 px at a median error in H0's frame <= 0.05 px;
    seed_pyramid, lm_fit and gather_cubes launch in every round; (2) a
    second ``process_all`` processes nothing and leaves every store file
    byte-identical; H2's two regions set back to flag 0 are processed
    again, alone, by one ``process_round``, into rows equal to the first
    run's; (3) ``device_deinterleave=True`` gives an equal store; (4)
    ``sequential_drift=True``: cumulative drifts within 0.1 px of the
    planted ones and the spot gates of (1); (5) two box nuclei (the FOV's
    halves) saved as the segmentation; ``generate_chromosome_image`` (the
    drift-aligned sum of the 8 regions) reads above 1.5x its median at
    every H0 planted spot (where its channel images it), and returns the
    cached image on a second call; ``identify_chromosomes(4)`` gives at
    most 4 per nucleus, each within 1.5 px of a planted spot and inside
    its box; ``select_chromosomes_by_spots(0.2, 0.5)`` keeps them all;
    (6) ``load_region_crops`` of a 20x256x256 window: H0's (drift 0) equal
    the loader's window over the profile bit for bit, the others finite
    and of the window's shape.  Every step is timed on the host clock
    around ``torch.cuda.synchronize()``."""
    import csv
    import shutil
    import tempfile

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.io import (FovStore, interleave_channels,
                                             load_dax_channels,
                                             save_correction_profile,
                                             write_dax)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops.warp import monomial_exponents
    from imageanalysis3_tpu_torch.pipeline import ExperimentDriver

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    shape, chans, n_z = SHAPE, list(DAX_CHANNELS), SHAPE[0]
    fov = "Conv_zscan_00.dax"
    stack_bytes = int(np.prod(shape)) * 2
    movie_bytes = (n_z * len(chans) + 2 * DAX_BUFFER) * stack_bytes // n_z
    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 8e9:
        raise AssertionError(f"experiment: {free / 1e9:.2f} GB free under "
                             f"{root}, need 8 GB for "
                             f"{EXP_ROUNDS * movie_bytes / 1e9:.2f} GB of "
                             f"movies")
    rec = {"shape": shape, "rounds": EXP_ROUNDS, "movie_bytes": movie_bytes,
           "seconds": {}, "launches": {}}
    secs = rec["seconds"]

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # ---- the experiment ---------------------------------------------------
    rng = np.random.default_rng(31)
    regions = {}                       # rid -> (round, channel index, truth)
    for r in range(EXP_ROUNDS):
        for ci in range(2):
            regions[2 * r + ci + 1] = (r, ci, syn.sample_spot_params(
                shape, N_SPOTS, rng, min_separation=8.0,
                height_range=EXP_HEIGHTS, sigma_jitter=0.0))
    beads = syn.sample_spot_params(shape, 500, rng, min_separation=14.0,
                                   height_range=(2000.0, 5000.0),
                                   sigma_jitter=0.0, background=120.0)
    drifts = np.vstack([np.zeros(3), rng.uniform(-2.0, 2.0,
                                                 (EXP_ROUNDS - 1, 3))])
    rec["planted_drifts"] = drifts.tolist()
    vig = syn.illumination_profile(shape[1:], falloff=0.35)
    vig_t = torch.as_tensor(vig.astype(np.float32), device=dev)
    half = np.asarray(shape, np.float64) / 2.0
    scale = np.array([1.0 / np.prod(half ** np.asarray(e))
                      for e in monomial_exponents(3, 2)])
    consts = (np.asarray(syn.PLANTED_SHIFTS[0]) * scale[None]
              ).astype(np.float32)

    def imaged(ci, centers):
        """Where channel ci images the sample points `centers`."""
        if ci == 0:
            return centers + syn._poly_shift_np(centers, consts, half)
        return centers

    tmp = tempfile.mkdtemp(prefix="experiment_", dir=root)
    try:
        data = os.path.join(tmp, "data")
        folders = []
        secs["write"] = 0.0
        for r in range(EXP_ROUNDS):
            t0 = time.perf_counter()
            chs = []
            for ci in range(2):
                t = regions[2 * r + ci + 1][2]
                im = syn.render_spots(
                    shape, imaged(ci, t["centers"] + drifts[r]),
                    t["heights"], background=150.0, device=dev)
                chs.append(syn.noisy_uint16(im, seed=100 + 10 * r + ci,
                                            illumination=vig_t))
                del im
            im = syn.render_spots(shape, beads["centers"] + drifts[r],
                                  beads["heights"], background=120.0,
                                  device=dev)
            chs.append(syn.noisy_uint16(im, seed=102 + 10 * r))
            del im
            movie = interleave_channels([c.cpu().numpy() for c in chs],
                                        buffer_frames=DAX_BUFFER)
            del chs
            secs[f"render_H{r}"] = time.perf_counter() - t0
            folder = os.path.join(data, f"H{r}R{r}")
            os.makedirs(folder)
            path = os.path.join(folder, fov)

            def write():
                write_dax(path, movie)
                with open(path, "rb+") as fh:
                    os.fsync(fh.fileno())
            timed("write_one", write)
            secs["write"] += secs.pop("write_one")
            folders.append(folder)
            del movie
        with open(os.path.join(data, "Color_Usage.csv"), "w",
                  newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["Hyb"] + chans)
            for r in range(EXP_ROUNDS):
                w.writerow([f"H{r}R{r}", f"u{2 * r + 1}", f"u{2 * r + 2}",
                            "beads"])
        corr_folder = os.path.join(tmp, "Corrections")
        save_correction_profile("illumination", {"750": vig, "647": vig},
                                corr_folder, ("750", "647"), im_size=shape)
        save_correction_profile("chromatic_constants",
                                {"750": consts, "647": None}, corr_folder,
                                ("750", "647"), im_size=shape)
        rec["write_GBps"] = EXP_ROUNDS * movie_bytes / secs["write"] / 1e9
        print(f"experiment: {EXP_ROUNDS} movies of {movie_bytes / 1e9:.3f} "
              f"GB written in {secs['write']:.3f} s "
              f"({rec['write_GBps']:.2f} GB/s); planted drifts "
              f"{drifts.round(4).tolist()}  [{smi}]")

        cfg = ExperimentConfig(
            image_size=shape, corr_channels=("750", "647"),
            correction=CorrectionConfig(),
            seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048),
            fit=FitConfig())

        def driver(save, **kw):
            return ExperimentDriver(data, os.path.join(tmp, save), cfg=cfg,
                                    correction_folder=corr_folder,
                                    device=dev, **kw)

        def check_spots(label, store):
            """Flags, drift flags, drifts and the spot gates of every
            region; returns the per-region readings."""
            out = {}
            for rid, (r, ci, t) in regions.items():
                spots, drift, flag = store.load_spots("unique", rid)
                dflag = int(store.drift_flags("unique")[
                    store.region_index("unique", rid)])
                derr = np.abs(drift + drifts[r])
                errs, n_m = _matched_errors(
                    torch, torch.as_tensor(spots[:, 1:4], device=dev),
                    t["centers"])
                med = float(np.median(errs)) if len(errs) else float("nan")
                out[rid] = {"round": r, "channel": chans[ci], "flag": flag,
                            "drift_flag": dflag,
                            "drift": drift.round(4).tolist(),
                            "drift_err": derr.round(4).tolist(),
                            "matched": n_m, "n_spots": len(spots),
                            "median_err_px": med}
                if (flag != 2 or dflag != 0 or derr.max() > 0.1
                        or n_m < 0.9 * N_SPOTS or not med <= 0.05):
                    raise AssertionError(f"experiment ({label}), region "
                                         f"u{rid}: {out[rid]}")
            print(f"experiment ({label}): per region "
                  f"{ {f'u{k}': v for k, v in out.items()} }")
            return out

        # ---- 1. process_all, default input mode, async writes ----------------
        drv = driver("save")
        per_round = []

        def counted(pipe, ims, ref_im):
            before = kernel_launches()
            res = ExperimentDriver._dispatch_round(pipe, ims, ref_im)
            per_round.append({k: n - before[k]
                              for k, n in kernel_launches().items()})
            return res

        drv._dispatch_round = counted
        # a first pass over H0's movie takes the first-call costs (cuFFT
        # plans, the allocator's growth, the loader's page cache) outside
        # the timed run; it writes nothing
        warm = driver("warm")
        warm._reference_image(fov)
        del warm
        reset_kernel_launches()
        counts = timed("process_all", drv.process_all)
        rec["launches"]["process_all"] = kernel_launches()
        rec["launches"]["per_round"] = list(per_round)
        if counts != {fov: {"unique": 2 * EXP_ROUNDS}}:
            raise AssertionError(f"experiment: process_all processed "
                                 f"{counts}")
        if len(per_round) != EXP_ROUNDS or any(
                c[name] < 1 for c in per_round for name in PYRAMID_PATH):
            raise AssertionError(f"experiment: a kernel of the path did not "
                                 f"launch in every round: {per_round}")
        path = drv.store_path(fov)
        ids = list(regions)
        with FovStore(path, "r") as store:
            rec["store_backend"] = store.backend
            rec["regions"] = check_spots("process_all", store)
            first = _store_rows(store, ids)
        rec["stage_seconds"] = drv.timings.summary()
        rec["s_per_round"] = {"default": secs["process_all"] / EXP_ROUNDS}
        print(f"experiment: store backend {rec['store_backend']} "
              f"({path}); process_all {secs['process_all']:.3f} s, "
              f"{rec['s_per_round']['default']:.4f} s/round; stages "
              f"{ {k: round(v, 4) for k, v in rec['stage_seconds'].items()} }"
              f" s; launches per round {per_round}  [{smi}]")

        # ---- 2. resume -------------------------------------------------------
        before = _tree_hashes(path)
        again = timed("resume_noop", drv.process_all)
        if again != {fov: {"unique": 0}} or _tree_hashes(path) != before:
            raise AssertionError(f"experiment: the resume no-op processed "
                                 f"{again} or changed the store")
        cleared = [rid for rid, (r, _, _) in regions.items() if r == 2]
        with FovStore(path) as store:
            for rid in cleared:
                store.set_flag("unique", rid, 0)
        n_rec = len(drv.timings.records)
        part = timed("partial_resume", lambda: drv.process_fov(fov))
        rounds_run = [x["folder"] for x in drv.timings.records[n_rec:]
                      if x["stage"] == "process_round"]
        with FovStore(path, "r") as store:
            redone = _store_rows(store, ids)
        if (part != {"unique": len(cleared)} or rounds_run != ["H2R2"]
                or not _rows_equal(redone, first)):
            raise AssertionError(f"experiment: partial resume processed "
                                 f"{part} in rounds {rounds_run}, rows "
                                 f"equal {_rows_equal(redone, first)}")
        print(f"experiment: resume no-op {secs['resume_noop']:.4f} s, "
              f"{len(before)} store files byte-identical; u{cleared} set "
              f"back to flag 0 -> {part} in rounds {rounds_run} "
              f"({secs['partial_resume']:.3f} s), rows equal to the first "
              f"run's  [{smi}]")

        # ---- 3. device de-interleave -----------------------------------------
        raw_drv = driver("save_raw", device_deinterleave=True)
        reset_kernel_launches()
        timed("process_all_raw", raw_drv.process_all)
        rec["launches"]["process_all_raw"] = kernel_launches()
        with FovStore(raw_drv.store_path(fov), "r") as store:
            if not _rows_equal(_store_rows(store, ids), first):
                raise AssertionError("experiment: device_deinterleave's "
                                     "store differs from the default mode's")
        rec["s_per_round"]["device_deinterleave"] = \
            secs["process_all_raw"] / EXP_ROUNDS
        rec["stage_seconds_raw"] = raw_drv.timings.summary()
        print(f"experiment (device_deinterleave): "
              f"{rec['s_per_round']['device_deinterleave']:.4f} s/round, "
              f"store equal to the default mode's; stages "
              f"{ {k: round(v, 4) for k, v in rec['stage_seconds_raw'].items()} }"
              f" s  [{smi}]")
        del raw_drv

        # ---- 4. sequential drift ---------------------------------------------
        seq = driver("save_seq", sequential_drift=True)
        reset_kernel_launches()
        timed("process_all_seq", seq.process_all)
        rec["launches"]["process_all_seq"] = kernel_launches()
        with FovStore(seq.store_path(fov), "r") as store:
            rec["sequential"] = check_spots("sequential_drift", store)
        rec["s_per_round"]["sequential"] = \
            secs["process_all_seq"] / EXP_ROUNDS
        rec["stage_seconds_seq"] = seq.timings.summary()
        print(f"experiment (sequential_drift): "
              f"{rec['s_per_round']['sequential']:.4f} s/round; stages "
              f"{ {k: round(v, 4) for k, v in rec['stage_seconds_seq'].items()} }"
              f" s; launches {rec['launches']['process_all_seq']}  [{smi}]")
        del seq

        # ---- 5. chromosomes --------------------------------------------------
        labels = np.zeros(shape, np.int32)
        labels[:, :EXP_SPLIT_X] = 1
        labels[:, EXP_SPLIT_X:] = 2
        with FovStore(path) as store:
            timed("save_segmentation",
                  lambda: store.save_segmentation(labels))
        del labels
        chrom = timed("generate_chromosome_image",
                      lambda: drv.generate_chromosome_image(fov))
        med = float(np.median(chrom))
        shown = np.concatenate([imaged(ci, t["centers"])
                                for r, ci, t in regions.values()])
        h0 = np.concatenate([imaged(ci, t["centers"])
                             for r, ci, t in regions.values() if r == 0])
        zi, xi, yi = np.clip(np.round(h0).astype(np.int64), 0,
                             np.asarray(shape) - 1).T
        low = int((chrom[zi, xi, yi] <= 1.5 * med).sum())
        cached = timed("chromosome_image_cached",
                       lambda: drv.generate_chromosome_image(fov))
        if low or not np.array_equal(cached, chrom):
            raise AssertionError(f"experiment: {low} of {len(h0)} H0 spots "
                                 f"read <= 1.5x the chromosome image's "
                                 f"median {med}, or the cached image "
                                 f"differs")
        del cached
        coords, labs, n_per = timed(
            "identify_chromosomes",
            lambda: drv.identify_chromosomes(fov, expected_per_nucleus=4))
        dist = np.linalg.norm(shown[None] - coords[:, None].astype(
            np.float64), axis=-1).min(axis=1)
        in_box = np.where(labs == 1, coords[:, 1] < EXP_SPLIT_X,
                          coords[:, 1] >= EXP_SPLIT_X)
        rec["chromosomes"] = {"coords": coords.tolist(),
                              "labels": labs.tolist(),
                              "per_nucleus": n_per,
                              "dist_px": dist.tolist(),
                              "median": med}
        if (not len(coords) or max(n_per.values()) > 4
                or dist.max() >= 1.5 or not in_box.all()):
            raise AssertionError(f"experiment: chromosome candidates "
                                 f"{rec['chromosomes']}")
        kept = timed("select_chromosomes_by_spots",
                     lambda: drv.select_chromosomes_by_spots(
                         fov, cand_spot_intensity_th=0.2,
                         good_chr_loss_th=0.5))
        if len(kept) != len(coords):
            raise AssertionError(f"experiment: select_chromosomes_by_spots "
                                 f"kept {len(kept)} of {len(coords)}")
        print(f"experiment: chromosome image {secs['generate_chromosome_image']:.3f}"
              f" s (cached {secs['chromosome_image_cached']:.3f} s; every H0 "
              f"spot > 1.5x the median {med:.1f}); identify_chromosomes "
              f"{secs['identify_chromosomes']:.3f} s: {len(coords)} "
              f"candidates {coords.tolist()}, labels {labs.tolist()}, "
              f"per nucleus {n_per}, max distance to a planted spot "
              f"{dist.max():.3f} px; select_chromosomes_by_spots "
              f"{secs['select_chromosomes_by_spots']:.3f} s kept "
              f"{len(kept)}  [{smi}]")
        del chrom

        # ---- 6. region crops -------------------------------------------------
        lims = np.array([[20, 40], [896, 1152], [896, 1152]])
        crops = timed("load_region_crops", lambda: drv.load_region_crops(
            fov, lims, "unique"))
        block = load_dax_channels(os.path.join(folders[0], fov), chans,
                                  chans, n_z=n_z, buffer_frames=DAX_BUFFER)
        prof = vig.astype(np.float32)[896:1152, 896:1152]
        want_shape = tuple(int(b - a) for a, b in lims)
        for rid, (r, ci, _) in regions.items():
            crop = crops[rid]
            if crop.shape != want_shape or not np.isfinite(crop).all():
                raise AssertionError(f"experiment: crop u{rid} "
                                     f"{crop.shape}, finite "
                                     f"{np.isfinite(crop).all()}")
            if r == 0:
                want = (block[ci, 20:40, 896:1152, 896:1152].astype(
                    np.float32) / prof[None])
                if not np.array_equal(crop, want):
                    raise AssertionError(f"experiment: H0's crop u{rid} "
                                         f"differs from the loader's "
                                         f"window over the profile")
        del block
        print(f"experiment: load_region_crops of {want_shape} for "
              f"{len(crops)} regions {secs['load_region_crops']:.3f} s; "
              f"H0's equal to the loader's window over the profile  [{smi}]")

        # ---- 7. FieldOfView ----------------------------------------------------
        rec["field_of_view"] = _field_of_view_step(
            torch, smi, timed, secs, data, os.path.join(tmp, "save"), cfg,
            corr_folder, fov, coords)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["total_launches"] = {k: rec["launches"]["process_all"][k]
                             for k in PYRAMID_PATH}
    print(f"experiment: steps "
          f"{ {k: round(v, 4) for k, v in secs.items()} } s  [{smi}]")
    return rec


#: phase 9's scale: a lab's cells at the e2e scene's width (300 regions);
#: 1 true candidate and 7 decoys a region and homolog
PICK_REGIONS = 300
PICK_DECOYS = 7
PICK_CELLS = 8
PICK_POPULATION = 2048
PICK_CPU_POPULATION = 256
PICK_PX = np.asarray([200.0, 108.0, 108.0])


def _planted_candidates(rng, zxys):
    """(R, 1 + PICK_DECOYS, 4) hzxy rows (nm) around one polymer trace and
    its true slot per region: the trace's point at 30 nm jitter, heights
    800-1500, among decoys spread 4000 nm around the trace's centre,
    heights 800-2500 (so they may be brighter), as tests/test_picking.py
    and tests/test_population_picking.py plant them."""
    r, m = len(zxys), 1 + PICK_DECOYS
    slot = rng.integers(0, m, r)
    pos = zxys.mean(0) + rng.normal(0, 4000.0, (r, m, 3))
    h = rng.uniform(800, 2500, (r, m))
    ar = np.arange(r)
    pos[ar, slot] = zxys + rng.normal(0, 30.0, (r, 3))
    h[ar, slot] = rng.uniform(800, 1500, r)
    return np.concatenate([h[..., None], pos], -1).astype(np.float32), slot


def _polymer_traces(rng, n, starts):
    """(len(starts), n, 3) random walks in nm, 300 nm steps."""
    steps = rng.normal(0, 300.0 / np.sqrt(3), (len(starts), n, 3))
    return np.asarray(starts, np.float64)[:, None] + np.cumsum(steps, 1)


def _planted_population(rng, n):
    """(hzxy (n, R, 8, 4) nm, valid, true slot (n, R), -1 where a region
    is empty), as tests/test_population_picking.py plants them: 10 % of
    regions empty, 1-8 candidates in the others, the trace's point at 30
    nm jitter (heights 800-1500) among decoys spread 3500 nm around the
    trace's centre (heights 800-2500)."""
    r, m = PICK_REGIONS, 1 + PICK_DECOYS
    traces = _polymer_traces(rng, r, rng.uniform(3000, 9000, (n, 3)))
    n_c = rng.integers(1, m + 1, (n, r))
    slot = rng.integers(0, n_c)
    keep = rng.uniform(size=(n, r)) >= 0.1
    pos = traces.mean(1)[:, None, None] + rng.normal(0, 3500.0,
                                                     (n, r, m, 3))
    h = rng.uniform(800, 2500, (n, r, m))
    i, j = np.indices((n, r))
    pos[i, j, slot] = traces + rng.normal(0, 30.0, (n, r, 3))
    h[i, j, slot] = rng.uniform(800, 1500, (n, r))
    valid = (np.arange(m) < n_c[..., None]) & keep[..., None]
    hzxy = np.where(valid[..., None],
                    np.concatenate([h[..., None], pos], -1), np.nan)
    return hzxy.astype(np.float32), valid, np.where(keep, slot, -1)


def _planted_cell(rng):
    """One cell of two homologs 10 um apart: (cand (R, 16, 11) px rows,
    valid, region ids, centres (2, 3) px, true slot (2, R))."""
    zxys = _polymer_traces(rng, PICK_REGIONS, [(3000.0, 5000.0, 5000.0),
                                               (3000.0, 12000.0, 12000.0)])
    m = 1 + PICK_DECOYS
    cand = np.zeros((PICK_REGIONS, 2 * m, 11), np.float32)
    truth = np.zeros((2, PICK_REGIONS), np.int64)
    for h in range(2):
        hzxy, slot = _planted_candidates(rng, zxys[h])
        cand[:, h * m:(h + 1) * m, 0] = hzxy[..., 0]
        cand[:, h * m:(h + 1) * m, 1:4] = hzxy[..., 1:4] / PICK_PX
        truth[h] = h * m + slot
    centers = (zxys.mean(1) / PICK_PX).astype(np.float32)
    return (cand, np.ones(cand.shape[:2], bool),
            np.arange(PICK_REGIONS, dtype=np.int32), centers, truth)


def _planted_groups(rng, n_groups=2000, n_free=2000):
    """A decoded cell's stand-in: tight bright pairs and triples (80 nm
    jitter) and free dim spots -> (SpotGroups, spots (N, 11), positions
    (N, 3) nm, valid), on the card."""
    import torch
    from imageanalysis3_tpu_torch.decode import SpotGroups

    size = 2 + np.arange(n_groups) % 2
    first = np.concatenate([[0], np.cumsum(size)[:-1]])
    n = int(size.sum()) + n_free
    pos = rng.uniform(0, 20000, (n, 3))
    owner = np.repeat(np.arange(n_groups), size)
    pos[:len(owner)] = (pos[first][owner]
                        + rng.normal(0, 80.0, (len(owner), 3)))
    spots = np.zeros((n, 11), np.float32)
    spots[:, 0] = np.concatenate([rng.uniform(800, 1500, len(owner)),
                                  rng.uniform(200, 900, n_free)])
    spots[:, 1:4] = pos / PICK_PX
    idx = np.full((n_groups, 3), -1, np.int64)
    for k in range(3):
        idx[:, k] = np.where(k < size, first + k, -1)
    usage = np.zeros(n, np.int32)
    usage[:len(owner)] = 1
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)
    groups = SpotGroups(spot_idx=t(idx), region=t(np.arange(
        n_groups, dtype=np.int32)), n_spots=t(size.astype(np.int32)),
        ok=t(np.ones(n_groups, bool)), spot_usage=t(usage))
    return groups, t(spots), t(pos.astype(np.float32)), t(np.ones(n, bool))


def _picking_phase(torch, smi: str, decoded=None) -> dict:
    """Phase 9: picking at a lab's width on the card, from planted inputs
    made with NumPy from seed 41: (a) ``em_pick_spots_exclusive`` on
    PICK_CELLS cells of two homologs, each one shared (300, 16) table, and
    ``check_picked_spots`` on each pick; (b)
    ``em_pick_spots_for_chromosomes(share_spots=True)`` on cell 0; (c)
    ``merge_spot_lists`` on cell 0's candidates concatenated with a copy
    moved 0.03 px (every copy merges into its original); (d)
    ``em_pick_spots_in_population`` on 2048 chromosomes x 300 regions x up
    to 8 candidates (``_planted_population``); (e) ``median_distance_map`` and ``contact_map`` over its
    2048 picked traces; (f) ``tuple_self_scores`` against
    ``collect_invalid_pairs``' nearest unused spots, on the e2e phase's
    decoded groups when given (`decoded`), else on planted groups.
    Gates, each a hard failure: planted recovery >= 0.9 of regions for
    every homolog and chromosome; no candidate picked by both homologs of
    a cell; cells 0 and 1, the merge and a 256-chromosome population equal
    to the port's CPU runs, up to f32 ties (``_picks_agree``); the median
    map of a 256-trace subset within 1e-3 relative of NumPy's float64
    ``nanmedian``; finite self-scores on every scored group.  Timed on the
    host clock around ``torch.cuda.synchronize()``; peak device memory."""
    from imageanalysis3_tpu_torch.analysis.distmap import (
        contact_map, median_distance_map)
    from imageanalysis3_tpu_torch.decode import (
        check_picked_spots, collect_invalid_pairs,
        em_pick_spots_exclusive, em_pick_spots_for_chromosomes,
        em_pick_spots_in_population, find_unused_spots, merge_spot_lists,
        tuple_self_scores)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    secs = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    def recovered(sel, ok, truth):
        return float(((np.asarray(sel) == truth) & np.asarray(ok)).mean())

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    rng = np.random.default_rng(41)
    rec = {"cells": [], "seconds": secs}
    cells = [_planted_cell(rng) for _ in range(PICK_CELLS)]

    # (a) exclusive EM, cell by cell, and the stringency screen
    for k, (cand, valid, ids, centers, truth) in enumerate(cells):
        args = [torch.as_tensor(a, device=dev)
                for a in (cand, valid, ids, centers)]
        res = timed("exclusive", lambda: em_pick_spots_exclusive(
            *args, device=dev))
        sel, ok = res.sel_idx.cpu().numpy(), res.sel_valid.cpu().numpy()
        kept = [timed("check", lambda: check_picked_spots(
            res.trace[h], res.sel_valid[h], args[3][h], device=dev))[0]
            for h in range(2)]
        cell = {"n_iters": int(res.n_iters[0]),
                "n_unresolved": res.n_unresolved.tolist(),
                "recovery": [recovered(sel[h], ok[h], truth[h])
                             for h in range(2)],
                "checked_kept": [int(c.sum()) for c in kept]}
        if k < 2:
            ref = em_pick_spots_exclusive(cand, valid, ids, centers,
                                          device="cpu")
            cell["differ_from_cpu_at_ties"] = _picks_agree(
                f"picking cell {k}", sel, ref.sel_idx, res.scores.cpu(),
                ref.scores)
        rec["cells"].append(cell)
        if min(cell["recovery"]) < 0.9:
            raise AssertionError(f"picking cell {k}: recovery {cell}")
        if (ok[0] & ok[1] & (sel[0] == sel[1])).any():
            raise AssertionError(f"picking cell {k}: a candidate picked by "
                                 f"both homologs")
    rec["s_per_cell"] = secs["exclusive"] / PICK_CELLS

    # (b) shared spots on cell 0
    cand, valid, ids, centers, truth = cells[0]
    res = timed("shared", lambda: em_pick_spots_for_chromosomes(
        cand, valid, ids, centers, share_spots=True, device=dev))
    rec["shared"] = {"n_iters": res.n_iters.tolist(), "recovery": [
        recovered(res.sel_idx[h].cpu(), res.sel_valid[h].cpu(), truth[h])
        for h in range(2)]}
    if min(rec["shared"]["recovery"]) < 0.9:
        raise AssertionError(f"picking, shared spots: {rec['shared']}")

    # (c) merging two passes' lists of cell 0
    flat = cand.reshape(-1, 11)
    moved = flat.copy()
    moved[:, 1:4] += 0.03
    both = np.concatenate([flat, moved])
    kept = timed("merge", lambda: merge_spot_lists(
        both, np.ones(len(both), bool), device=dev)).cpu()
    kept_cpu = merge_spot_lists(both, np.ones(len(both), bool), device="cpu")
    rec["merge"] = {"spots": len(both), "kept": int(kept.sum())}
    if not torch.equal(kept, kept_cpu) or int(kept[:len(flat)].sum()) \
            != len(flat) or kept[len(flat):].any():
        raise AssertionError(f"picking, merge: {rec['merge']}, equal to the "
                             f"CPU's {torch.equal(kept, kept_cpu)}")

    # (d) the population EM
    hzxy, pvalid, slots = _planted_population(rng, PICK_POPULATION)
    pids = np.arange(PICK_REGIONS)
    pop = timed("population", lambda: em_pick_spots_in_population(
        hzxy, pvalid, pids, device=dev))
    has = slots >= 0
    rec["population"] = {
        "shape": list(hzxy.shape), "candidates": int(pvalid.sum()),
        "n_iters": int(pop.n_iters), "change_ratio": float(pop.change_ratio),
        "recovery": float((pop.sel_idx.cpu().numpy()[has]
                           == slots[has]).mean())}
    if rec["population"]["recovery"] < 0.9:
        raise AssertionError(f"picking, population: {rec['population']}")
    sub = slice(0, PICK_CPU_POPULATION)
    pop_sub = em_pick_spots_in_population(hzxy[sub], pvalid[sub], pids,
                                          device=dev)
    pop_cpu = em_pick_spots_in_population(hzxy[sub], pvalid[sub], pids,
                                          device="cpu")
    rec["population"]["differ_from_cpu_at_ties"] = _picks_agree(
        "picking, population", pop_sub.sel_idx.cpu(), pop_cpu.sel_idx,
        pop_sub.sel_scores.cpu(), pop_cpu.sel_scores)

    # (e) distance maps of the picked traces
    zxys = pop.sel_hzxys[..., 1:4]                 # NaN where a region is empty
    med = timed("median_distance_map", lambda: median_distance_map(zxys))
    cont = timed("contact_map", lambda: contact_map(zxys))
    sub_med = median_distance_map(zxys[sub]).cpu().numpy()
    z64 = zxys[sub].cpu().numpy().astype(np.float64)
    want = np.nanmedian(np.sqrt(((z64[:, :, None] - z64[:, None]) ** 2
                                 ).sum(-1)), axis=0)
    err = np.abs(sub_med - want) / np.maximum(np.abs(want), 1e-30)
    rec["maps"] = {"shape": list(med.shape), "subset_max_rel_err":
                   float(np.nanmax(err)),
                   "mean_contact": float(cont.mean())}
    if (not np.array_equal(np.isnan(sub_med), np.isnan(want))
            or not np.nanmax(err) <= 1e-3
            or not bool(torch.isfinite(med).all())
            or not bool(torch.isfinite(cont).all())):
        raise AssertionError(f"picking, median distance map: {rec['maps']}")
    del med, cont, zxys

    # (f) tuple self-scores against nearest-unused invalid pairs
    if decoded is None:
        groups, spots, pos, svalid = _planted_groups(rng)
        rec["groups_from"] = "planted"
    else:
        groups, spots, pos, svalid = decoded
        rec["groups_from"] = "e2e decode"
    unused = find_unused_spots(groups, svalid)
    pairs = timed("collect_invalid_pairs",
                  lambda: collect_invalid_pairs(pos, unused))
    scores = timed("tuple_self_scores", lambda: tuple_self_scores(
        groups, spots, pos, *pairs)).cpu().numpy()
    scored = np.isfinite(scores)
    rec["self_scores"] = {"groups": int(groups.ok.sum()),
                          "scored": int(scored.sum()),
                          "invalid_pairs": int(pairs[2].sum()),
                          "mean": float(scores[scored].mean())}
    if (not scored.any() or not np.isneginf(scores[~scored]).all()
            or not int(pairs[2].sum())):
        raise AssertionError(f"picking, self-scores: {rec['self_scores']}")

    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["launches"] = kernel_launches()
    rec["phase_seconds"] = time.perf_counter() - t_phase
    print(f"picking: phase {rec['phase_seconds']:.1f} s with its CPU "
          f"references; {PICK_CELLS} exclusive cells {rec['s_per_cell']:.4f} "
          f"s/cell, {rec['cells']}; shared {rec['shared']}; merge "
          f"{rec['merge']}; population {rec['population']}; maps "
          f"{rec['maps']}; self-scores ({rec['groups_from']}) "
          f"{rec['self_scores']}; seconds "
          f"{ {k: round(v, 4) for k, v in secs.items()} }; peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; kernel launches "
          f"{rec['launches']}  [{smi}]")
    return rec


#: phase 10's scene: a lab's FOV of segmented nuclei at bench.py's width
CELL_GRID = 8                       # nuclei per row and column
CELL_PITCH = 256                    # px between nucleus centres in x and y
CELL_SEMI = (30.0, 70.0, 70.0)      # ellipsoid semi-axes (z, x, y) px
CELL_DIM = 20                       # dim spots a nucleus
CELL_DIM_HEIGHTS = (800.0, 1500.0)
CELL_CLUTTER = 400                  # bright spots outside the nuclei
CELL_CLUTTER_HEIGHT = 6000.0
CELL_TH_SEED = 250.0
CELL_NUM_SPOTS = 64
CELL_SEARCH = 3                     # segment_search_radius
CELL_PATH = ("seed_classify", "lm_fit", "gather_cubes")
#: phase 10 (c): chromosomes (name, regions, copies) of a male cell, 8
#: candidates a region: the true spot of each homolog and dim decoys
CELL_CHROMS = (("1", 300, 2), ("2", 100, 2), ("X", 100, 1))
CELL_CANDIDATES = 8
CELL_PICK_CELLS = 8
CELL_TRACE_STARTS = {"1": [(3000.0, 5000.0, 5000.0),
                           (3000.0, 15000.0, 15000.0)],
                     "2": [(4000.0, 15000.0, 5000.0),
                           (4000.0, 5000.0, 15000.0)],
                     "X": [(5000.0, 10000.0, 10000.0)]}


def _nucleus_centres(shape):
    """(cell id, (z, x, y) centre) of each nucleus of the grid."""
    g, p = CELL_GRID, CELL_PITCH
    return [(1 + g * i + j, np.array([(shape[0] - 1) / 2.0,
                                      p / 2.0 + p * i, p / 2.0 + p * j]))
            for i in range(g) for j in range(g)]


def _ellipsoid_value(p, centre, semi=CELL_SEMI):
    return (((np.asarray(p) - centre) / np.asarray(semi)) ** 2).sum(-1)


def _nucleus_box(centre, shape, semi=CELL_SEMI):
    """The (lo, hi) voxel box that holds one planted nucleus."""
    lo = np.maximum(np.floor(centre - np.asarray(semi)).astype(int), 0)
    hi = np.minimum(np.ceil(centre + np.asarray(semi)).astype(int) + 1,
                    shape)
    return lo, hi


def _grid_nuclei(shape):
    """(cell id, centre, semi-axes) of phase 10's grid of nuclei."""
    return [(cid, c, CELL_SEMI) for cid, c in _nucleus_centres(shape)]


def _nuclei_labels(torch, shape, dev, nuclei=None, scale=1.0):
    """The int32 label volume on `dev` of ellipsoidal nuclei (default
    phase 10's grid), each semi-axis times `scale`; a voxel inside two
    goes to the one whose ellipsoid value is lower (the first on a tie)."""
    nuclei = _grid_nuclei(shape) if nuclei is None else nuclei
    labels = torch.zeros(shape, dtype=torch.int32, device=dev)
    cen = torch.tensor([(0.0, 0.0, 0.0)] + [tuple(c) for _, c, _ in nuclei],
                       dtype=torch.float64, device=dev)
    sem = torch.tensor([(1.0, 1.0, 1.0)] + [tuple(np.asarray(s) * scale)
                                            for _, _, s in nuclei],
                       dtype=torch.float64, device=dev)
    slot = torch.zeros(int(max(cid for cid, _, _ in nuclei)) + 1,
                       dtype=torch.int64, device=dev)
    slot[torch.tensor([cid for cid, _, _ in nuclei], device=dev)] = \
        torch.arange(1, len(nuclei) + 1, device=dev)
    for cid, c, semi in nuclei:
        semi = np.asarray(semi) * scale
        lo, hi = _nucleus_box(c, shape, semi)
        axes = [torch.arange(lo[a], hi[a], device=dev, dtype=torch.float64)
                for a in range(3)]
        grid = (axes[0][:, None, None], axes[1][None, :, None],
                axes[2][None, None, :])
        v = sum(((grid[a] - c[a]) / semi[a]) ** 2 for a in range(3))
        box = labels[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        k = slot[box.long()]
        v_cur = sum(((grid[a] - cen[k, a]) / sem[k, a]) ** 2
                    for a in range(3))
        box[(v <= 1.0) & ((box == 0) | (v < v_cur))] = cid
    return labels


def _nuclei_scene(torch, rng, shape, dev, nuclei=None):
    """Phase 10's scene: the label volume (int32 on `dev`) of ellipsoidal
    nuclei (default phase 10's grid), CELL_DIM dim spots inside each (at
    most 0.75 of the way to its surface, 8 px apart), CELL_CLUTTER bright
    spots at least 8 px outside every nucleus, rendered over background 150
    with shot and read noise (bench.py's scene) -> (labels, uint16 stack,
    {cell: (20, 3) dim centres}, (n, 3) clutter centres)."""
    from imageanalysis3_tpu_torch import synthetic as syn

    nuclei = _grid_nuclei(shape) if nuclei is None else nuclei
    labels = _nuclei_labels(torch, shape, dev, nuclei)
    dim = {}
    for cid, c, semi in nuclei:
        pts = []
        while len(pts) < CELL_DIM:
            p = c + rng.uniform(-1, 1, 3) * semi
            if _ellipsoid_value(p, c, semi) > 0.75 ** 2:
                continue
            if all(np.linalg.norm(p - q) >= 8.0 for q in pts):
                pts.append(p)
        dim[cid] = np.asarray(pts)
    clutter = []
    margin = 1.0 + 8.0 / min(min(s) for _, _, s in nuclei)
    centres = np.asarray([c for _, c, _ in nuclei])
    semis = np.asarray([s for _, _, s in nuclei])
    while len(clutter) < CELL_CLUTTER:
        p = np.array([rng.uniform(8, shape[0] - 8),
                      rng.uniform(8, shape[1] - 8),
                      rng.uniform(8, shape[2] - 8)])
        if (_ellipsoid_value(p, centres, semis) <= margin ** 2).any():
            continue
        if all(np.linalg.norm(p - q) >= 8.0 for q in clutter[-200:]):
            clutter.append(p)
    clutter = np.asarray(clutter)
    centers = np.vstack([np.vstack(list(dim.values())), clutter])
    heights = np.concatenate([
        rng.uniform(*CELL_DIM_HEIGHTS, len(nuclei) * CELL_DIM),
        np.full(len(clutter), CELL_CLUTTER_HEIGHT)])
    im = syn.render_spots(shape, centers, heights, background=150.0,
                          device=dev)
    stack = syn.noisy_uint16(im, seed=61)
    return labels, stack, dim, clutter


def _cell_recovery(spots, ids, dim):
    """Per planted dim spot, the distance to the nearest kept spot of its
    own cell -> (matched distances (< 1 px), n planted)."""
    d_all = []
    for cid, pts in dim.items():
        mine = spots[ids == cid][:, 1:4]
        for p in pts:
            d_all.append(np.linalg.norm(mine - p, axis=1).min()
                         if len(mine) else np.inf)
    d_all = np.asarray(d_all)
    return d_all[d_all < 1.0], len(d_all)


def _near_own_mask(torch, labels, spots, ids, radius):
    """Whether each spot's (2r+1)^3 cube around its rounded centre holds a
    voxel of its own cell (an explicit gather, apart from spots_to_labels)."""
    shape = torch.tensor(labels.shape, device=labels.device)
    g = torch.arange(-radius, radius + 1, device=labels.device)
    offs = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    base = torch.round(spots[:, 1:4]).to(torch.int64)
    pos = base[:, None] + offs[None]
    inb = ((pos >= 0) & (pos < shape)).all(-1)
    pos = torch.minimum(pos.clamp_min(0), shape - 1)
    lab = labels[pos[..., 0], pos[..., 1], pos[..., 2]]
    return ((lab == ids[:, None].to(lab.dtype)) & inb).any(dim=1)


def _plain_spot_image(torch, spots, shape, radius=8):
    """The spot render one spot at a time (each spot's window sliced out of
    the image and added to, in spot order): reconstruct_spot_image's plain
    version, use_intensity=True, the spots' own widths."""
    out = torch.zeros(shape, dtype=torch.float32, device=spots.device)
    s = spots.double().cpu().numpy()
    for k in range(len(s)):
        cen = spots[k, 1:4].to(torch.float32)
        base = np.round(s[k, 1:4].astype(np.float32)).astype(np.int64)
        lo = np.maximum(base - radius, 0)
        hi = np.minimum(base + radius + 1, shape)
        if (hi <= lo).any():
            continue
        axes = [torch.arange(int(lo[a]), int(hi[a]), device=spots.device,
                             dtype=torch.float32) for a in range(3)]
        sig = torch.as_tensor(np.maximum(s[k, 5:8], 1e-3).astype(np.float32),
                              device=spots.device)
        q = [((axes[a] - cen[a]) / sig[a]) ** 2 for a in range(3)]
        qsum = q[0][:, None, None] + q[1][None, :, None] + q[2][None, None, :]
        out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] += \
            spots[k, 0].to(torch.float32) * torch.exp(-0.5 * qsum)
    return out


def _planted_pick_cell(rng):
    """One cell of phase 10 (c): per CELL_CHROMS chromosome, polymer traces
    of its copies (300 nm steps, from CELL_TRACE_STARTS) and per region
    CELL_CANDIDATES candidate spots in a random order: the trace's point at
    30 nm jitter (heights 800-1500) for each copy, the rest decoys spread
    4000 nm around a trace's centre at heights 200-900 (the picker weighs
    intensity 5 of 8, so decoys are dimmer than most true spots, as
    tests/test_picker.py plants its distractors) -> (candidate spot rows
    (N, 11) px, bits (N,), {chr: (copies, R) true row}), bit = region
    index + 1."""
    rows, bits, truth, region = [], [], {}, 0
    for chrom, n, copies in CELL_CHROMS:
        tr = _polymer_traces(rng, n, CELL_TRACE_STARTS[chrom][:copies])
        truth[chrom] = np.zeros((copies, n), np.int64)
        for r in range(n):
            slots = rng.permutation(CELL_CANDIDATES)
            for s in slots:
                if s < copies:
                    zxy = tr[s, r] + rng.normal(0, 30.0, 3)
                    h = rng.uniform(800, 1500)
                    truth[chrom][s, r] = len(rows)
                else:
                    zxy = tr[rng.integers(copies)].mean(0) \
                        + rng.normal(0, 4000.0, 3)
                    h = rng.uniform(200, 900)
                row = np.zeros(11)
                row[0], row[1:4], row[5:8] = h, zxy / PICK_PX, 1.5
                rows.append(row)
                bits.append(region + 1)
            region += 1
    return np.asarray(rows), np.asarray(bits), truth


def _sequential_codebook():
    """The sequential codebook of CELL_CHROMS: region k reads bit k + 1 and
    is named 'chr:start-end' (1 Mb apart)."""
    names, chrs = [], []
    for chrom, n, _ in CELL_CHROMS:
        for r in range(n):
            names.append(f"{chrom}:{(r + 1) * 1_000_000}-"
                         f"{(r + 1) * 1_000_000 + 500_000}")
            chrs.append(chrom)
    n = len(names)
    cb = {"name": np.asarray(names), "id": np.arange(n),
          "chr": np.asarray(chrs)}
    eye = np.eye(n, dtype=np.int8)
    for b in range(n):
        cb[str(b + 1)] = eye[:, b]
    return cb


def _picker_coords(mapped):
    """The picker's candidate table from SpotMapper's: positions in nm,
    the fitted height as intensity."""
    return {"region_name": mapped["region_name"], "chr": mapped["chr"],
            "start": mapped["start"], "end": mapped["end"],
            **{f"center_{a}": mapped[a] * px
               for a, px in zip(("z", "x", "y"), PICK_PX)},
            "center_intensity": mapped["height"]}


def _pick_recovery(picker, truth):
    """Per chromosome and homolog, the share of regions whose filtered pick
    is the planted spot of the planted homolog it matches best."""
    out = {}
    for chrom, t in truth.items():
        inds = picker.chr_2_filtered_inds[chrom].cpu().numpy()
        out[chrom] = [float(max((inds[h] == t[p]).mean()
                                for p in range(len(t))))
                      for h in range(len(inds))]
    return out


def _cell_kernel_checks(torch, crops, seeds, peaks, smi: str) -> dict:
    """The three kernels of the per-cell path at its launch shapes, each
    against its plain version: seed_classify on the nucleus crops (the
    common crop shape) and on a 12x32x32 crop (the JAX test's scale) within
    _check_seed_classify's tolerances; lm_fit on a crop's round 0 (its
    seeds, P = 512, 30 iterations) and its refit within _check_lm's; the
    gather's ball entry at the crop's seeds (r = 5), equal.  CUDA-event
    medians over the crops with the plain versions' and the bounds."""
    from imageanalysis3_tpu_torch.ops import gather_kernel as gk
    from imageanalysis3_tpu_torch.ops import lm_kernel
    from imageanalysis3_tpu_torch.ops import seed_kernels as sk
    from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d

    k_fg, k_bg = gaussian_kernel1d(0.75), gaussian_kernel1d(7.5)
    out = {}
    cls_in = [(*sk.z_pass_pair(c, k_fg, k_bg), k_fg, k_bg, CELL_TH_SEED,
               N_LVL, EDGE) for c in crops]
    small = crops[0][24:36, 60:92, 60:92].contiguous()
    checks = [_check_seed_classify(torch, sk, inp) for inp in cls_in]
    small_chk = _check_seed_classify(
        torch, sk, (*sk.z_pass_pair(small, k_fg, k_bg), k_fg, k_bg,
                    CELL_TH_SEED, N_LVL, EDGE))
    ms = _events_ms(torch, sk.fused_seed_classify_cuda, cls_in,
                    queue_ahead=True)
    plain_ms = _events_ms(torch, sk.fused_seed_classify_plain, cls_in,
                          queue_ahead=False)
    nvox = float(crops[0].numel())
    kb, kf = len(k_bg), len(k_fg)
    n_qual = max(c["n_qual"] for c in checks)
    bound = _bound(4 * nvox * 3 + 4 * N_LVL,
                   nvox * (2 * (2 * kf - 1) + 2 * (2 * kb - 1) + 55)
                   + 4 * n_qual, peaks)
    out["seed_classify"] = {
        "shape": list(crops[0].shape), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1],
        "max_abs_err": max(c["max_abs_err"] for c in checks + [small_chk]),
        "n_disagree": [c["n_disagree"] for c in checks],
        "small_12x32x32": small_chk}
    print(f"cell spots kernels: seed_classify PASS at {tuple(crops[0].shape)}"
          f" on {len(crops)} crops (qualification differs on "
          f"{out['seed_classify']['n_disagree']} voxels, max |dqdiff| "
          f"{out['seed_classify']['max_abs_err']:.3g}) and at 12x32x32 "
          f"(max |dqdiff| {small_chk['max_abs_err']:.3g}, identical "
          f"{small_chk['identical']}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({ms / bound[0]:.2f}x)  [{smi}]")

    r0s = [_lm_round0(torch, c, s.coords.to(torch.float32), s.valid, 5, 30)
           for c, s in zip(crops, seeds)]
    shape = tuple(crops[0].shape)
    batches = {"round 0": ([r["lm_in"] for r in r0s],
                           [(r["svalid"], r["base"]) for r in r0s])}
    ref_in, ref_ok = [], []
    for r in r0s:
        pp, ep = lm_kernel.lm_fit_plain(*r["lm_in"])
        lm_in, sel = _lm_refit(torch, r, pp, ep)
        ref_in.append(lm_in)
        ref_ok.append((r["svalid"][sel], r["base"][sel]))
    batches["refit"] = (ref_in, ref_ok)
    for label, (inputs, oks) in batches.items():
        err, n_valid, decided = 0.0, [], []
        for lm_in, (sv, base) in zip(inputs, oks):
            e, nv, _, dec = _check_lm(torch, f"cell crop {label}", lm_in, sv,
                                      base, shape)
            err, n_valid = max(err, e), n_valid + [nv]
            decided.append(dec)
        ms = _events_ms(torch, lm_kernel.lm_fit_cuda, inputs,
                        queue_ahead=True)
        plain_ms = _events_ms(torch, lm_kernel.lm_fit_plain, inputs,
                              queue_ahead=False)
        n, p = inputs[0][0].shape
        it = inputs[0][8]
        bound = _lm_bound(n, p, it, peaks)
        out[f"lm_fit {label}"] = {
            "spots": n, "px": p, "iters": it, "n_valid": n_valid,
            "order_decided": decided, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"cell spots kernels: lm_fit {label} PASS  {n} spots x {p} px "
              f"x {it} iters, valid {n_valid}, decided by the summation "
              f"order {decided}, max |dcentre| {err:.3g} px; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} "
              f"ms by {bound[1]} ({ms / bound[0]:.2f}x)  [{smi}]")

    ball_in = [(c, s.coords.to(torch.float32), 5) for c, s in zip(crops,
                                                                  seeds)]
    for inp in ball_in:
        got, want = gk.gather_ball_cuda(*inp), gk.gather_ball_plain(*inp)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("gather_cubes (ball) at the cell crops: "
                                 "differs from its plain version")
    ms = _events_ms(torch, gk.gather_ball_cuda, ball_in, queue_ahead=True)
    plain_ms = _events_ms(torch, gk.gather_ball_plain, ball_in,
                          queue_ahead=False)
    lib_in = [(c, _ball_flat_index(torch, gk, c.shape, s, r))
              for c, s, r in ball_in]
    lib_ms = _events_ms(torch, lambda im, idx: im.reshape(-1)[idx], lib_in,
                        queue_ahead=True)
    n, p = ball_in[0][1].shape[0], len(gk.ball_offsets(5))
    bound = _bound(n * p * (4 + 4 + 12 + 1) + 12 * (n + p), 0.0, peaks)
    out["gather_cubes"] = {"seeds": n, "radius": 5, "px": p,
                           "max_abs_err": 0.0, "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound[0], "bound_by": bound[1]}
    print(f"cell spots kernels: gather_cubes (ball) PASS  {n} seeds x {p} px"
          f" (r = 5), equal to its plain version; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, im.reshape(-1)[idx] {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x)  [{smi}]")
    return out


def _cell_spots_phase(torch, smi: str, peaks) -> dict:
    """Phase 10: the per-cell spot path at a lab's width, on the card.

    (a) Per-cell fit: one 60x2048x2048 uint16 channel of an 8x8 grid of
    ellipsoidal nuclei (semi-axes 30x70x70 px, 256 px apart), 20 dim spots
    (800-1500) in each and 400 bright ones (6000) outside them
    (_nuclei_scene), written as a one-channel .dax movie into build/ and
    read by ``DaxProcesser._load_image``; then
    ``DaxProcesser._fit_spots_by_segmentation`` (th_seed 250, 64 spots a
    cell) with every kernel count set to 0 just before and read just
    after: seed_classify, lm_fit and gather_cubes must launch.  Gates: >=
    90 % of the 1280 planted dim spots found in their own cell within 1 px
    at a median error <= 0.05 px; every kept spot within
    segment_search_radius of its own cell's mask; the port's CPU run on
    the 2x2 block of nuclei at the origin equal in its cells and spots to
    the card's (centres within 1e-3 px, heights rtol 1e-2, widths 1e-3);
    the three kernels against their plain versions at the path's launch
    shapes (_cell_kernel_checks).  Reported: each crop's seconds (seeding
    and fit apart), the step's, and what whole-FOV ``fit_fov_image``
    finds with 64 seeds and with 64 a cell.  (b) Spot tables: the kept
    spots with their cell ids as a column table, saved and loaded through
    the .npy backend (and h5py where it imports), bit for bit;
    ``spots_to_labels`` (r = 10) over them equal to their cells;
    ``count_genes``; ``reconstruct_spot_image`` of the 60x2048x2048
    stack within rtol 1e-5 / atol 1e-6 of the plain one-spot-at-a-time
    render.  (c) Decode and pick: CELL_PICK_CELLS planted cells
    (_planted_pick_cell: chromosomes 1, 2 and X of 300, 100 and 100
    regions, 2, 2 and 1 copies, 8 candidates a region) as a sequential
    codebook and candidate tables; ``SpotMapper`` then
    ``SpotPicker.iterative_assignment(max_niter=10)`` on the card per
    cell; planted recovery >= 0.9 per homolog; the picks of cells 0 and 1
    equal to the port's CPU run, n_iterations too; ``batch_pick_spots`` on
    cell 0 written as a decoded file in the .npy layout, equal to the
    in-memory picks, and ``load_picked`` equal to what was saved;
    ``interpolate_chr`` on every picked trace.  Timed on the host clock
    around ``torch.cuda.synchronize()``."""
    import shutil
    import tempfile

    from imageanalysis3_tpu_torch.analysis import (count_genes,
                                                   interpolate_chr,
                                                   spots_to_labels)
    from imageanalysis3_tpu_torch.decode import (SpotMapper, SpotPicker,
                                                 batch_pick_spots)
    from imageanalysis3_tpu_torch.io import (interleave_channels,
                                             load_table_hdf5,
                                             save_table_hdf5, spots_to_table,
                                             write_dax)
    from imageanalysis3_tpu_torch.io.store import _h5py
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops import cell_fitting as cf
    from imageanalysis3_tpu_torch.ops.gaussian_fit import fit_fov_image
    from imageanalysis3_tpu_torch.ops.seeding import get_seeds
    from imageanalysis3_tpu_torch.pipeline import DaxProcesser
    from imageanalysis3_tpu_torch.spots import reconstruct_spot_image

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    secs = {}
    rec = {"seconds": secs}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    shape = SHAPE
    rng = np.random.default_rng(60)
    labels, stack, dim, clutter = timed(
        "scene", lambda: _nuclei_scene(torch, rng, shape, dev))
    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    movie_bytes = (shape[0] + 2 * DAX_BUFFER) * shape[1] * shape[2] * 2
    free = shutil.disk_usage(root).free
    if free < 2 * movie_bytes:
        raise AssertionError(f"cell spots: {free / 1e9:.2f} GB free under "
                             f"{root}, need {2 * movie_bytes / 1e9:.2f}")
    tmp = tempfile.mkdtemp(prefix="cell_spots_", dir=root)
    try:
        # ---- (a) per-cell fit ------------------------------------------
        path = os.path.join(tmp, "H0", "Conv_zscan_00.dax")
        os.makedirs(os.path.dirname(path))
        movie = interleave_channels([stack.cpu().numpy()],
                                    buffer_frames=DAX_BUFFER)
        timed("write_dax", lambda: write_dax(path, movie))
        del movie
        proc = DaxProcesser(path, correction_channels=["750"],
                            all_channels=["750"], single_im_size=shape,
                            num_buffer_frames=DAX_BUFFER, device=dev)
        timed("load_image", proc._load_image)
        if not torch.equal(proc.ims["750"], stack.to(torch.float32)):
            raise AssertionError("cell spots: the loaded stack differs from "
                                 "the written one")
        del stack
        im = proc.ims["750"]
        # one untimed call first, as every timed path of this script
        proc._fit_spots_by_segmentation(
            "750", labels, th_seed=CELL_TH_SEED, num_spots=CELL_NUM_SPOTS,
            segment_search_radius=CELL_SEARCH)
        sync()
        reset_kernel_launches()
        spots, ids = timed("fit_by_segmentation",
                           lambda: proc._fit_spots_by_segmentation(
                               "750", labels, th_seed=CELL_TH_SEED,
                               num_spots=CELL_NUM_SPOTS,
                               segment_search_radius=CELL_SEARCH))
        launches = kernel_launches()
        rec["launches"] = launches
        for name in CELL_PATH:
            if launches[name] < 1:
                raise AssertionError(f"cell spots: kernel {name} did not "
                                     f"launch on the per-cell path: "
                                     f"{launches}")
        sp_np, ids_np = spots.cpu().numpy(), ids.cpu().numpy()
        matched, n_planted = _cell_recovery(sp_np, ids_np, dim)
        rec["fit"] = {"kept": len(sp_np), "cells": int(len(np.unique(ids_np))),
                      "planted": n_planted, "matched": len(matched),
                      "median_err_px": float(np.median(matched))
                      if len(matched) else float("nan"),
                      "per_cell_kept": np.bincount(ids_np).tolist()}
        if not (len(matched) >= 0.9 * n_planted
                and rec["fit"]["median_err_px"] <= 0.05):
            raise AssertionError(f"cell spots: per-cell fit {rec['fit']}")
        near = _near_own_mask(torch, labels, spots, ids, CELL_SEARCH)
        if not bool(near.all()):
            raise AssertionError(f"cell spots: {int((~near).sum())} kept "
                                 f"spots lie beyond segment_search_radius "
                                 f"of their cell's mask")

        # each crop alone: seeding and fit apart
        boxes = cf.segmentation_bounding_boxes(labels, pad=3)
        cids = sorted(boxes)
        crop = cf._common_crop_shape([boxes[c] for c in cids], shape)
        origins = []
        for c in cids:
            lo, hi = boxes[c]
            origins.append(np.round((lo + hi) / 2.0 - np.asarray(crop) / 2.0))
        origins = np.clip(np.asarray(origins, np.int64), 0,
                          np.asarray(shape) - np.asarray(crop))
        crops, crop_seeds, seed_s, fit_s = [], [], [], []
        for o in origins:
            c = im[o[0]:o[0] + crop[0], o[1]:o[1] + crop[1],
                   o[2]:o[2] + crop[2]].contiguous()
            sync()
            t0 = time.perf_counter()
            s = get_seeds(c, max_num_seeds=CELL_NUM_SPOTS,
                          th_seed=CELL_TH_SEED)
            sync()
            t1 = time.perf_counter()
            cf.fit_spots_in_crops(c, np.zeros((1, 3), np.int64), crop,
                                  max_num_seeds=CELL_NUM_SPOTS,
                                  th_seed=CELL_TH_SEED)
            sync()
            seed_s.append(t1 - t0)
            fit_s.append(time.perf_counter() - t1)
            if len(crops) < 3:
                crops.append(c)
                crop_seeds.append(s)
        rec["crop_shape"] = list(crop)
        # a crop's whole fit (seeding included) and its seeding alone
        rec["per_crop_s"] = {
            "seeding_median": statistics.median(seed_s),
            "crop_median": statistics.median(fit_s),
            "crop_min": min(fit_s), "crop_max": max(fit_s),
            "crops": len(fit_s)}
        rec["kernels"] = _cell_kernel_checks(torch, crops, crop_seeds, peaks,
                                             smi)
        del crops, crop_seeds

        # the port's CPU run on the 2x2 block of nuclei at the origin
        block = 2 * CELL_PITCH
        sub_ids = [1 + CELL_GRID * i + j for i in range(2) for j in range(2)]
        t0 = time.perf_counter()
        cpu_sp, cpu_ids = cf.fit_spots_by_segmentation(
            im[:, :block, :block].cpu(), labels[:, :block, :block].cpu(),
            th_seed=CELL_TH_SEED, num_spots=CELL_NUM_SPOTS,
            segment_search_radius=CELL_SEARCH)
        secs["cpu_reference_4_cells"] = time.perf_counter() - t0
        mine = np.isin(ids_np, sub_ids)
        card_sp, card_ids = sp_np[mine], ids_np[mine]
        cpu_sp, cpu_ids = cpu_sp.numpy(), cpu_ids.numpy()
        if not np.array_equal(card_ids, cpu_ids):
            raise AssertionError(f"cell spots: the CPU run keeps "
                                 f"{np.bincount(cpu_ids).tolist()} spots a "
                                 f"cell, the card "
                                 f"{np.bincount(card_ids).tolist()}")
        # pair each card spot with the CPU's nearest in its cell (seeds of
        # near-equal height may rank apart between the devices)
        d = np.linalg.norm(card_sp[:, None, 1:4] - cpu_sp[None, :, 1:4],
                           axis=-1)
        d[card_ids[:, None] != cpu_ids[None, :]] = np.inf
        pair = d.argmin(axis=1)
        if len(np.unique(pair)) != len(pair):
            raise AssertionError("cell spots: the card's spots do not pair "
                                 "one to one with the CPU run's")
        cpu_sp = cpu_sp[pair]
        d_cen = np.abs(card_sp[:, 1:4] - cpu_sp[:, 1:4]).max()
        d_h = (np.abs(card_sp[:, 0] - cpu_sp[:, 0])
               / np.abs(cpu_sp[:, 0])).max()
        d_w = np.abs(card_sp[:, 5:8] - cpu_sp[:, 5:8]).max()
        rec["cpu_reference"] = {"spots": len(cpu_sp), "max_dcentre": float(
            d_cen), "max_rel_dheight": float(d_h), "max_dwidth": float(d_w)}
        if not (d_cen <= 1e-3 and d_h <= 1e-2 and d_w <= 1e-3):
            raise AssertionError(f"cell spots: card vs CPU "
                                 f"{rec['cpu_reference']}")

        # whole-FOV fitting with the same budgets
        whole = {}
        for label, budget in (("64 seeds", CELL_NUM_SPOTS),
                              ("64 a cell", CELL_NUM_SPOTS * len(cids))):
            res = timed(f"fit_fov_image {label}", lambda: fit_fov_image(
                im, max_num_seeds=budget, th_seed=CELL_TH_SEED))
            got = res.spots[res.valid].cpu().numpy()
            d = []
            for pts in dim.values():
                for p in pts:
                    d.append(np.linalg.norm(got[:, 1:4] - p, axis=1).min()
                             if len(got) else np.inf)
            d = np.asarray(d)
            whole[label] = {"budget": budget, "valid": int(len(got)),
                            "dim_found": int((d < 1.0).sum()),
                            "dim_lost": int((d >= 1.0).sum())}
        rec["whole_fov"] = whole
        print(f"cell spots (a): crop {tuple(crop)}, {len(cids)} cells; "
              f"kept {rec['fit']['kept']}, {rec['fit']['matched']} of "
              f"{n_planted} planted found in their cell at a median "
              f"{rec['fit']['median_err_px']:.5f} px; all within "
              f"{CELL_SEARCH} px of their mask; step "
              f"{secs['fit_by_segmentation']:.4f} s "
              f"({secs['fit_by_segmentation'] / len(cids) * 1e3:.2f} ms a "
              f"crop); each crop alone {rec['per_crop_s']}; launches "
              f"{launches}; CPU reference on 4 cells "
              f"{rec['cpu_reference']} in "
              f"{secs['cpu_reference_4_cells']:.2f} s; whole FOV {whole}"
              f"  [{smi}]")

        # ---- (b) spot tables -------------------------------------------
        table = timed("spots_to_table", lambda: spots_to_table(
            spots, np.ones(len(sp_np), np.int64), ["750"] * len(sp_np),
            fov_id=0, cell_id=ids, uid="fov0"))
        backends = ["npy"] + (["h5py"] if _h5py() is not None else [])
        rec["tables"] = {}
        for backend in backends:
            tpath = os.path.join(tmp, f"cell_spots.{backend}")
            timed(f"save_table_{backend}", lambda: save_table_hdf5(
                table, tpath, "cell_spots", backend=backend))
            back = timed(f"load_table_{backend}", lambda: load_table_hdf5(
                tpath, "cell_spots", backend=backend))
            same = list(back) == list(table) and all(
                (back[c].tobytes() == table[c].tobytes()
                 and back[c].dtype == table[c].dtype)
                if table[c].dtype.kind in "biuf"
                else list(back[c]) == [str(v) for v in table[c]]
                for c in table)
            rec["tables"][backend] = same
            if not same:
                raise AssertionError(f"cell spots: the {backend} table "
                                     f"differs from the saved one")
        got_lab = timed("spots_to_labels", lambda: spots_to_labels(
            labels, spots[:, 1:4], torch.ones(len(sp_np), dtype=torch.bool,
                                              device=dev),
            search_radius=10))
        if not torch.equal(got_lab, ids):
            raise AssertionError("cell spots: spots_to_labels (r = 10) "
                                 "differs from the kept spots' cells")
        counts, cells, _ = timed("count_genes",
                                 lambda: count_genes({1: got_lab}))
        if not np.array_equal(counts[:, 0],
                              np.bincount(ids_np)[cells]):
            raise AssertionError("cell spots: count_genes differs from the "
                                 "kept spots per cell")
        img = timed("reconstruct_spot_image", lambda: reconstruct_spot_image(
            spots, shape, use_intensity=True))
        plain = timed("reconstruct_plain", lambda: _plain_spot_image(
            torch, spots, shape))
        err = float((img - plain).abs().max())
        ok = bool(torch.allclose(img, plain, rtol=1e-5, atol=1e-6))
        rec["render"] = {"max_abs_err": err, "max": float(img.max()),
                         "spots": len(sp_np)}
        del img, plain
        if not ok:
            raise AssertionError(f"cell spots: reconstruct_spot_image vs "
                                 f"its plain version {rec['render']}")
        steps_b = {k: round(v, 4) for k, v in secs.items() if k.startswith(
            ("save", "load_table", "spots_", "count", "recon"))}
        print(f"cell spots (b): table of {len(sp_np)} spots x "
              f"{len(table)} columns equal after "
              f"{' and '.join(backends)}; spots_to_labels (r = 10) equal to "
              f"the cells; count_genes over {len(cells)} cells; render "
              f"{rec['render']}; seconds {steps_b}  [{smi}]")
        del labels, proc, im, spots

        # ---- (c) decode and pick ---------------------------------------
        codebook = _sequential_codebook()
        prng = np.random.default_rng(62)
        pcells = [_planted_pick_cell(prng) for _ in range(CELL_PICK_CELLS)]
        rec["pick"] = []
        pickers = []
        for k, (rows, bits, truth) in enumerate(pcells):
            cand = spots_to_table(rows, bits, ["647"] * len(bits), fov_id=0,
                                  cell_id=k)
            mapped = timed("spot_mapper",
                           lambda: SpotMapper(cand, codebook).filtered_spots)
            coords = _picker_coords(mapped)
            picker = SpotPicker(coords, codebook, device=dev)
            timed("picker", lambda: picker.iterative_assignment(max_niter=10))
            if len(mapped["bit"]) != len(rows):
                raise AssertionError(f"cell spots: SpotMapper kept "
                                     f"{len(mapped['bit'])} of {len(rows)} "
                                     f"candidates, all of whose bits map")
            recov = _pick_recovery(picker, truth)
            traces = [picker.chr_2_filtered_hzxys[c][h, :, 1:]
                      for c in picker.chr_2_filtered_hzxys
                      for h in range(picker.chr_2_filtered_hzxys[c].shape[0])]
            filled = timed("interpolate_chr",
                           lambda: [interpolate_chr(t) for t in traces])
            cell = {"n_iterations": picker.n_iterations,
                    "recovery": recov, "candidates": len(rows),
                    "traces_finite": all(bool(np.isfinite(f).all())
                                         for f in filled)}
            if k < 2:
                ref = SpotPicker(coords, codebook, device="cpu")
                ref.iterative_assignment(max_niter=10)
                same = (ref.n_iterations == picker.n_iterations and all(
                    torch.equal(ref.chr_2_homolog_inds[c],
                                picker.chr_2_homolog_inds[c].cpu())
                    and torch.equal(ref.chr_2_filtered_inds[c],
                                    picker.chr_2_filtered_inds[c].cpu())
                    for c in picker.chr_2_homolog_inds))
                cell["equal_to_cpu"] = same
                if not same:
                    raise AssertionError(f"cell spots: picks of cell {k} "
                                         f"differ from the CPU run's")
            rec["pick"].append(cell)
            pickers.append((coords, picker))
            if min(min(v) for v in recov.values()) < 0.9 or \
                    not cell["traces_finite"]:
                raise AssertionError(f"cell spots: picking cell {k}: {cell}")
        coords, picker = pickers[0]
        dec = os.path.join(tmp, "decoded_cell0")
        save_table_hdf5(coords, dec, "seqLib/candSpots", backend="npy")
        save_table_hdf5(codebook, dec, "seqLib/codebook", backend="npy")
        picked = os.path.join(tmp, "picked_cell0")
        os.makedirs(picked)
        again = timed("batch_pick_spots", lambda: batch_pick_spots(
            dec, picked, num_expected_lib=1, device=dev))
        back = timed("load_picked", lambda: SpotPicker.load_picked(
            picked, device=dev))
        equal_batch = all(torch.equal(again.chr_2_homolog_inds[c],
                                      picker.chr_2_homolog_inds[c])
                          for c in picker.chr_2_homolog_inds)
        equal_back = all(
            torch.equal(getattr(back, name)[c].nan_to_num(-7.0),
                        getattr(again, name)[c].nan_to_num(-7.0))
            for name in ("chr_2_homolog_hzxys", "chr_2_homolog_inds",
                         "chr_2_filtered_hzxys", "chr_2_filtered_inds",
                         "chr_2_homolog_centers", "chr_2_scores")
            for c in getattr(again, name)) \
            and back.chr_2_copy_num == again.chr_2_copy_num
        rec["batch_pick"] = {"equal_to_in_memory": equal_batch,
                             "round_trip_equal": equal_back}
        if not (equal_batch and equal_back):
            raise AssertionError(f"cell spots: batch_pick_spots / "
                                 f"load_picked {rec['batch_pick']}")
        rec["s_per_pick_cell"] = (secs["spot_mapper"] + secs["picker"]) \
            / CELL_PICK_CELLS
        print(f"cell spots (c): {CELL_PICK_CELLS} cells of "
              f"{pcells[0][0].shape[0]} candidates: "
              f"{[c['n_iterations'] for c in rec['pick']]} iterations, "
              f"recovery {[c['recovery'] for c in rec['pick']]}; cells 0, 1 "
              f"equal to the CPU's; {rec['s_per_pick_cell']:.4f} s a cell "
              f"(SpotMapper {secs['spot_mapper'] / CELL_PICK_CELLS:.4f}, "
              f"picker {secs['picker'] / CELL_PICK_CELLS:.4f}); "
              f"interpolate_chr "
              f"{secs['interpolate_chr'] / CELL_PICK_CELLS:.4f} s a cell; batch_pick_spots {secs['batch_pick_spots']:.4f} s,"
              f" load_picked {secs['load_picked']:.4f} s, both equal  [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_seconds"] = time.perf_counter() - t_phase
    print(f"cell spots: phase {rec['phase_seconds']:.1f} s with its CPU "
          f"references; peak memory {rec['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; seconds { {k: round(v, 4) for k, v in secs.items()} }  "
          f"[{smi}]")
    return rec


#: phase 12's scene: phase 10's grid of nuclei as a DAPI channel, four grid
#: positions holding a touching pair each, and a polyT channel
SEG_PAIRS = ((1, 1), (2, 5), (5, 2), (6, 6))
SEG_PAIR_SEMI = (30.0, 60.0, 60.0)  # each member of a pair
SEG_PAIR_HALF = 56.0                # member centres +-56 px in x (8 px overlap)
SEG_BRIGHTNESS = (800.0, 1100.0)    # per nucleus
SEG_GRADIENT = 0.15                 # +-15 % along a random direction in xy
SEG_SPECKLE = 0.1                   # lognormal sigma, multiplicative
SEG_BACKGROUND = 100.0
SEG_READ_NOISE = 10.0
SEG_HALO = 1.5                      # polyT halo, x the nucleus semi-axes
SEG_HALO_EDGE = 16                  # px in xy: a cell ends inside the halo
                                    # dilated by 2 sigma (the polyT is
                                    # smoothed at sigma 8 before its cut)
SEG_POLYT = 600.0
SEG_PX = (250.0, 108.0, 108.0)      # nm per voxel (z, x, y)


def _seg_nuclei(shape):
    """Phase 12's nuclei: (cell id, centre, semi-axes) of phase 10's grid
    with each SEG_PAIRS position holding two touching nuclei, and the pairs'
    (id, id)."""
    nuclei, pairs = [], []
    for i in range(shape[1] // CELL_PITCH):
        for j in range(shape[2] // CELL_PITCH):
            c = np.array([(shape[0] - 1) / 2.0, CELL_PITCH / 2.0
                          + CELL_PITCH * i, CELL_PITCH / 2.0 + CELL_PITCH * j])
            if (i, j) in SEG_PAIRS:
                pairs.append((len(nuclei) + 1, len(nuclei) + 2))
                for sign in (-1.0, 1.0):
                    nuclei.append((len(nuclei) + 1,
                                   c + np.array([0.0, sign * SEG_PAIR_HALF,
                                                 0.0]), SEG_PAIR_SEMI))
            else:
                nuclei.append((len(nuclei) + 1, c, CELL_SEMI))
    return nuclei, pairs


def _noisy(torch, im, gen):
    """Multiplicative lognormal speckle, then read noise, in place."""
    im *= torch.exp(SEG_SPECKLE * torch.randn(im.shape, generator=gen,
                                              device=im.device))
    im += SEG_READ_NOISE * torch.randn(im.shape, generator=gen,
                                       device=im.device)
    return im


def _dapi_scene(torch, rng, shape, dev, nuclei, seed=120):
    """Phase 12's channels on `dev`: each nucleus of its own brightness
    (SEG_BRIGHTNESS) with a +-15 % gradient along a random xy direction, a
    polyT halo of SEG_HALO x its semi-axes, both over SEG_BACKGROUND with
    speckle and read noise -> (planted labels, dapi, polyT, halo labels)."""
    labels = _nuclei_labels(torch, shape, dev, nuclei)
    bright = rng.uniform(*SEG_BRIGHTNESS, len(nuclei))
    angle = rng.uniform(0.0, 2.0 * np.pi, len(nuclei))
    dapi = torch.full(shape, SEG_BACKGROUND, dtype=torch.float32, device=dev)
    for k, (cid, c, semi) in enumerate(nuclei):
        lo, hi = _nucleus_box(c, shape, semi)
        xs = torch.arange(lo[1], hi[1], device=dev, dtype=torch.float32)
        ys = torch.arange(lo[2], hi[2], device=dev, dtype=torch.float32)
        proj = ((xs[:, None] - c[1]) * np.cos(angle[k])
                + (ys[None, :] - c[2]) * np.sin(angle[k])) / semi[1]
        box = dapi[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        inside = labels[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] == cid
        box += torch.where(inside, bright[k] * (1.0 + SEG_GRADIENT * proj),
                           0.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _noisy(torch, dapi, gen)
    halo = _nuclei_labels(torch, shape, dev, nuclei, scale=SEG_HALO)
    polyt = _noisy(torch, SEG_BACKGROUND + SEG_POLYT * (halo > 0).to(
        torch.float32), gen)
    return labels, dapi, polyt, halo


#: phase 12's segmentation parameters: sigma in finest-pitch px (8 x 8 x
#: 3.5 voxels at SEG_PX), one seed a nucleus
SEG_SMOOTH = 8.0
SEG_MIN_DIST = 100.0
SEG_MAX_NUCLEI = 128
SEG_MIN_SIZE = 20000                # voxels, segment_nuclei / segment_cells
SEG_SCREEN = dict(min_size_voxels=100000, min_shape_ratio=0.03,
                  boundary_margin=8)
SEG_SPLIT = dict(max_size_voxels=800000, smooth_sigma=SEG_SMOOTH,
                 seed_min_distance=100.0, max_seeds_per_label=2,
                 pixel_sizes=SEG_PX)
SEG_CROP = (3, 3)                   # grid position of the CPU-checked crop
SEG_CROP_XY = 256
SEG_IOU = 0.85                      # single nuclei
SEG_PAIR_IOU = 0.6                  # members of a touching pair
#: the learned path: init_unet_params' full width, trained on one pooled
#: crop, then the FOV at downsample (1, 4, 4)
SEG_DOWN = (1, 4, 4)
SEG_TRAIN_XY = 128                  # pooled px
SEG_TRAIN_STEPS = 200
SEG_LR = 2e-3
SEG_LEARNED_IOU = 0.6
SEG_LEARNED_SHARE = 0.9
SEG_UNET_CPU = (20, 64, 64)         # pooled crop held against the CPU
#: cellpose's 'nuclei' geometry on (d)'s pooled volume edge-padded to 64
#: planes
SEG_CP_Z = 64


def _best_iou(torch, labels, truth, n_truth):
    """Per planted id 1..n_truth: (best IoU, the label that gives it) over
    the labels it overlaps, from one joint histogram on the device."""
    lab = labels.reshape(-1).long()
    tru = truth.reshape(-1).long()
    n_lab = int(lab.max()) + 1
    joint = torch.bincount(tru * n_lab + lab, minlength=(n_truth + 1)
                           * n_lab).reshape(n_truth + 1, n_lab).cpu().numpy()
    t_size, l_size = joint.sum(1), joint.sum(0)
    inter = joint[1:, 1:].astype(np.float64)
    iou = inter / np.maximum(t_size[1:, None] + l_size[None, 1:] - inter, 1)
    if iou.shape[1] == 0:
        return np.zeros(n_truth), np.zeros(n_truth, np.int64)
    return iou.max(1), iou.argmax(1) + 1


def _seg_dapi(torch, dev, shape, scene, timed, smi):
    """Phase 12 (a): segment_nuclei -> screen_labels ->
    split_oversized_nuclei on the DAPI channel, the gates on the planted
    nuclei, and a 60 x 256 x 256 crop on the card against the CPU."""
    from imageanalysis3_tpu_torch.segmentation import nuclei as sn

    nuclei, pairs, truth, dapi = (scene[k] for k in ("nuclei", "pairs",
                                                     "truth", "dapi"))
    kw = dict(smooth_sigma=SEG_SMOOTH, seed_min_distance=SEG_MIN_DIST,
              max_num_nuclei=SEG_MAX_NUCLEI, min_size_voxels=SEG_MIN_SIZE,
              pixel_sizes=SEG_PX)
    torch.cuda.reset_peak_memory_stats()
    labels, _coords, valid = timed("segment_nuclei",
                                   lambda: sn.segment_nuclei(dapi, **kw))
    rec = {"sweeps": sn.propagation_sweeps(), "seeds": int(valid.sum())}
    screened = timed("screen_labels",
                     lambda: sn.screen_labels(labels, **SEG_SCREEN))
    split = timed("split_oversized_nuclei",
                  lambda: sn.split_oversized_nuclei(dapi, screened,
                                                    **SEG_SPLIT))
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    n = len(nuclei)
    iou, best = _best_iou(torch, split, truth, n)
    member = {i for pair in pairs for i in pair}
    singles = [cid for cid, _, _ in nuclei if cid not in member]
    rec.update(labels=int(len(torch.unique(split))) - 1, planted=n,
               single_iou_min=float(min(iou[c - 1] for c in singles)),
               single_iou_median=float(np.median([iou[c - 1]
                                                  for c in singles])),
               pair_iou=[[round(float(iou[a - 1]), 4),
                          round(float(iou[b - 1]), 4)] for a, b in pairs],
               pair_labels=[[int(best[a - 1]), int(best[b - 1])]
                            for a, b in pairs])
    if rec["labels"] != n or rec["single_iou_min"] < SEG_IOU:
        raise AssertionError(f"segmentation (a): {rec}")
    for (a, b), (la, lb) in zip(pairs, rec["pair_labels"]):
        if la == lb or min(iou[a - 1], iou[b - 1]) < SEG_PAIR_IOU:
            raise AssertionError(f"segmentation (a): pair {(a, b)} not "
                                 f"split into two: {rec}")
    # the crop: one nucleus, cut by a few px, and its neighbours' edges
    ci, cj = SEG_CROP
    x0 = CELL_PITCH * ci + CELL_PITCH // 2 - SEG_CROP_XY // 4
    y0 = CELL_PITCH * cj + CELL_PITCH // 2 - SEG_CROP_XY // 4
    crop = dapi[:, x0:x0 + SEG_CROP_XY, y0:y0 + SEG_CROP_XY].contiguous()
    card = sn.segment_nuclei(crop, **kw)[0]
    card_sweeps = sn.propagation_sweeps()
    t0 = time.perf_counter()
    cpu = sn.segment_nuclei(crop.cpu(), **kw)[0]
    rec["cpu_crop_s"] = time.perf_counter() - t0
    differ = int((card.cpu() != cpu).sum())
    rec["crop"] = {"shape": list(crop.shape), "labels": int(cpu.max()),
                   "differing_voxels": differ, "sweeps_card": card_sweeps,
                   "sweeps_cpu": sn.propagation_sweeps()}
    if differ or card_sweeps != rec["crop"]["sweeps_cpu"]:
        raise AssertionError(f"segmentation (a): the crop's labels on the "
                             f"card differ from the CPU's: {rec['crop']}")
    print(f"segmentation (a): {rec['labels']} labels for {n} planted "
          f"nuclei ({len(pairs)} touching pairs, each split in two, member "
          f"IoU {rec['pair_iou']}); single nuclei IoU min "
          f"{rec['single_iou_min']:.4f}, median "
          f"{rec['single_iou_median']:.4f}; {rec['seeds']} seeds, "
          f"{rec['sweeps']} propagation sweeps; crop {tuple(crop.shape)} "
          f"equal to the CPU's ({rec['cpu_crop_s']:.2f} s on the CPU); peak "
          f"memory {rec['peak_memory_bytes'] / 2**30:.2f} GiB  [{smi}]")
    return rec, split, best


def _seg_cell_spots(torch, dev, shape, scene, labels, best, timed, smi):
    """Phase 12 (b): the segmented nuclei into the per-cell spot path on a
    spot channel planted in the same nuclei."""
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.pipeline import DaxProcesser

    nuclei = scene["nuclei"]
    _, stack, dim, _clutter = timed("spot_scene", lambda: _nuclei_scene(
        torch, np.random.default_rng(60), shape, dev, nuclei))
    proc = DaxProcesser("unwritten.dax", correction_channels=["750"],
                        all_channels=["750"], single_im_size=shape,
                        device=dev)
    proc.ims["750"] = stack.to(torch.float32)
    del stack
    torch.cuda.synchronize()
    reset_kernel_launches()
    spots, ids = timed("fit_by_segmentation",
                       lambda: proc._fit_spots_by_segmentation(
                           "750", labels, th_seed=CELL_TH_SEED,
                           num_spots=CELL_NUM_SPOTS,
                           segment_search_radius=CELL_SEARCH))
    launches = kernel_launches()
    for name in CELL_PATH:
        if launches[name] < 1:
            raise AssertionError(f"segmentation (b): kernel {name} did not "
                                 f"launch: {launches}")
    sp, cid = spots.cpu().numpy(), ids.cpu().numpy()
    mapped = {int(best[c - 1]): pts for c, pts in dim.items()}
    matched, n_planted = _cell_recovery(sp, cid, mapped)
    rec = {"launches": launches, "kept": len(sp), "planted": n_planted,
           "matched": len(matched),
           "median_err_px": float(np.median(matched)) if len(matched)
           else float("nan")}
    near = _near_own_mask(torch, labels, spots, ids, CELL_SEARCH)
    rec["beyond_mask"] = int((~near).sum())
    if not (len(matched) >= 0.9 * n_planted
            and rec["median_err_px"] <= 0.05 and rec["beyond_mask"] == 0):
        raise AssertionError(f"segmentation (b): {rec}")
    print(f"segmentation (b): segmented nuclei through "
          f"_fit_spots_by_segmentation: {rec['matched']} of {n_planted} "
          f"planted spots in their own cell at a median "
          f"{rec['median_err_px']:.5f} px, {rec['kept']} kept, all within "
          f"{CELL_SEARCH} px of their mask; launches {launches}  [{smi}]")
    return rec


def _seg_cells(torch, dev, scene, timed, smi):
    """Phase 12 (c): segment_cells on DAPI + polyT: each cell holds its
    nucleus and ends inside the polyT halos."""
    from imageanalysis3_tpu_torch.segmentation import nuclei as sn

    cells, nucs = timed("segment_cells", lambda: sn.segment_cells(
        scene["dapi"], scene["polyt"], pixel_sizes=SEG_PX,
        smooth_sigma=SEG_SMOOTH, seed_min_distance=SEG_MIN_DIST,
        max_num_nuclei=SEG_MAX_NUCLEI, min_size_voxels=SEG_MIN_SIZE))
    r = SEG_HALO_EDGE
    edge = (scene["halo"] > 0).to(torch.float16)[None, None]
    edge = torch.nn.functional.max_pool3d(edge, (1, 2 * r + 1, 1), 1,
                                          (0, r, 0))
    edge = torch.nn.functional.max_pool3d(edge, (1, 1, 2 * r + 1), 1,
                                          (0, 0, r))[0, 0]
    rec = {"sweeps": sn.propagation_sweeps(),
           "cells": int(len(torch.unique(cells))) - 1,
           "nucleus_outside_its_cell": int(((nucs > 0) & (cells != nucs))
                                           .sum()),
           "beyond_halo": int(((cells > 0) & (edge == 0)).sum()),
           "beyond_halo_1_5": int(((cells > 0) & (scene["halo"] == 0))
                                  .sum()),
           "cell_voxels_per_nucleus_voxel": float((cells > 0).sum())
           / max(float((nucs > 0).sum()), 1.0)}
    rec["nuclei"] = int(len(torch.unique(nucs))) - 1
    if (rec["nucleus_outside_its_cell"] or rec["beyond_halo"]
            or rec["cell_voxels_per_nucleus_voxel"] < 1.3
            or rec["cells"] != rec["nuclei"]
            or rec["cells"] < len(scene["nuclei"]) - len(scene["pairs"])):
        raise AssertionError(f"segmentation (c): {rec}")
    print(f"segmentation (c): segment_cells: {rec['cells']} cells, each "
          f"holding its nucleus and inside the {SEG_HALO} x halos dilated "
          f"by {SEG_HALO_EDGE} px ({rec['beyond_halo_1_5']} voxels beyond the "
          f"halos themselves); "
          f"{rec['cell_voxels_per_nucleus_voxel']:.3f} cell voxels a "
          f"nucleus voxel; {rec['sweeps']} sweeps of the polyT expansion  "
          f"[{smi}]")
    return rec


def _seg_learned(torch, dev, scene, timed, secs, smi):
    """Phase 12 (d): the 3D UNet at init_unet_params' full width trained on
    one pooled crop, then segment_fov_learned over the FOV."""
    from imageanalysis3_tpu_torch.segmentation import learned as sl

    im = torch.stack([scene["dapi"], scene["polyt"]])
    c, z, x, y = im.shape
    dz, dx, dy = SEG_DOWN
    pooled = im.reshape(c, z // dz, dz, x // dx, dx, y // dy, dy).mean(
        dim=(2, 4, 6))
    truth_p = scene["truth"][::dz, dx // 2::dx, dy // 2::dy]
    crop = pooled[:, :, :SEG_TRAIN_XY, :SEG_TRAIN_XY].contiguous()
    crop_truth = truth_p[:, :SEG_TRAIN_XY, :SEG_TRAIN_XY].cpu().numpy()
    net = sl.init_unet_params(torch.Generator().manual_seed(121),
                              in_channels=2, base=16, levels=3, device=dev)
    trained = timed("fit_unet", lambda: sl.fit_unet(
        net, [crop], [crop_truth], n_steps=SEG_TRAIN_STEPS, lr=SEG_LR))
    rec_prof = _fit_step_profile(torch, sl, trained, crop, crop_truth)
    labels = timed("segment_fov_learned", lambda: sl.segment_fov_learned(
        im, trained, downsample=SEG_DOWN, max_cells=SEG_MAX_NUCLEI))
    del im
    n = len(scene["nuclei"])
    iou, _ = _best_iou(torch, labels, scene["truth"], n)
    rec = {"labels": int(labels.max()), "iou_median": float(np.median(iou)),
           "iou_min": float(iou.min()),
           "share_at_bar": float((iou >= SEG_LEARNED_IOU).mean()),
           "s_per_step": secs["fit_unet"] / SEG_TRAIN_STEPS,
           "fov_s": secs["segment_fov_learned"], "step_profile": rec_prof}
    # the card's forward on one pooled crop against the CPU's
    zc, xc, yc = SEG_UNET_CPU
    small = pooled[:, :zc, :xc, :yc].contiguous()
    with torch.no_grad():
        f_card, l_card = sl.unet_apply(trained, small)
        cpu_net = copy.deepcopy(trained).cpu()
        f_cpu, l_cpu = sl.unet_apply(cpu_net, small.cpu())
    rec["unet_cpu_max_abs_err"] = max(
        float((f_card.cpu() - f_cpu).abs().max()),
        float((l_card.cpu() - l_cpu).abs().max()))
    if rec["share_at_bar"] < SEG_LEARNED_SHARE:
        raise AssertionError(f"segmentation (d): {rec}")
    if rec["unet_cpu_max_abs_err"] > 1e-4:
        raise AssertionError(f"segmentation (d): unet_apply on the card vs "
                             f"the CPU {rec['unet_cpu_max_abs_err']}")
    print(f"segmentation (d): UNet3D (2 in, base 16, 3 levels) trained "
          f"{SEG_TRAIN_STEPS} steps on a {tuple(crop.shape)} pooled crop, "
          f"{rec['s_per_step']:.4f} s a step; segment_fov_learned over "
          f"{tuple(scene['dapi'].shape)} x 2 at {SEG_DOWN} in "
          f"{rec['fov_s']:.3f} s: {rec['labels']} labels, planted nuclei at "
          f"IoU >= {SEG_LEARNED_IOU}: {100 * rec['share_at_bar']:.1f} % "
          f"(median {rec['iou_median']:.4f}, min {rec['iou_min']:.4f}); "
          f"unet_apply on {SEG_UNET_CPU} within "
          f"{rec['unet_cpu_max_abs_err']:.3g} of the CPU; a profiled step: "
          f"{rec_prof['device_ms']:.2f} ms on the device, weight gradients "
          f"{rec_prof['wgrad_ms']:.2f} ms, top {rec_prof['top'][:4]}  "
          f"[{smi}]")
    return rec, pooled


def _fit_step_profile(torch, sl, net, crop, crop_truth, steps=2) -> dict:
    """Device time of `steps` more fit_unet steps under torch.profiler, per
    step: the total, cuDNN's weight-gradient kernels, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    sl.fit_unet(net, [crop], [crop_truth], n_steps=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sl.fit_unet(net, [crop], [crop_truth], n_steps=steps)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / steps, ev.key))
    rows.sort(reverse=True)
    return {"device_ms": sum(r[0] for r in rows),
            "wgrad_ms": sum(r[0] for r in rows if "wgrad" in r[1]),
            "top": [[round(ms, 3), key[:60]] for ms, key in rows[:8]]}


def _cpnet_random(torch, dev, seed=122):
    """cellpose's 'nuclei' CPnet with every weight and BatchNorm statistic
    drawn from a seeded generator (torch's default init scale, the
    statistics as tests/test_cellpose_net.py draws them)."""
    from imageanalysis3_tpu_torch.segmentation import cellpose_net as cp

    gen = torch.Generator().manual_seed(seed)
    net = cp.CPnet(cp.DEFAULT_NBASE)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                bound = 1.0 / np.sqrt(m.weight[0].numel())
                for t in (m.weight, m.bias):
                    t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1)
                            * bound)
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.5)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.3)
    return net.to(dev).eval()


def _cpnet_flops(torch, net, h, w) -> float:
    """Convolution and Linear FLOPs of one (h, w) slice, from the layer
    shapes a forward of one slice meets (2 x in x out x taps x outputs)."""
    total = [0.0]

    def hook(m, _inp, out):
        taps = int(np.prod(m.kernel_size)) if hasattr(m, "kernel_size") \
            else 1
        spatial = out.shape[-1] * out.shape[-2] \
            if isinstance(m, torch.nn.Conv2d) else 1
        total[0] += 2.0 * m.in_features * m.out_features * out.shape[0] \
            if isinstance(m, torch.nn.Linear) else \
            2.0 * m.in_channels * m.out_channels * taps * spatial \
            * out.shape[0]

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(torch.zeros((1, net.nbase[0], h, w),
                            device=next(net.parameters()).device))
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def _seg_cellpose(torch, dev, pooled, timed, secs, peaks, smi):
    """Phase 12 (e): CPnet at cellpose's nuclei geometry on (d)'s pooled
    volume edge-padded in z to SEG_CP_Z planes: the three views timed, the
    flows and labels, one slice against the CPU, the achieved f32 rate."""
    from imageanalysis3_tpu_torch.segmentation import cellpose_net as cp

    net = _cpnet_random(torch, dev)
    pad = SEG_CP_Z - pooled.shape[1]
    vol = torch.cat([pooled, pooled[:, -1:].expand(-1, pad, -1, -1)], dim=1)
    c, z, x, y = vol.shape
    # each view's chunks timed where cellpose_flows_3d runs them
    run_view, n_view = cp._run_view, [0]

    def timed_view(net_, slices):
        n_view[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield from run_view(net_, slices)
        torch.cuda.synchronize()
        secs[f"cellpose view {n_view[0]}"] = time.perf_counter() - t0

    cp._run_view = timed_view
    try:
        flow, prob = timed("cellpose_flows_3d",
                           lambda: cp.cellpose_flows_3d(net, vol))
    finally:
        cp._run_view = run_view
    views, flops = {}, 0.0
    for k, (n_slices, h, w) in enumerate(((z, x, y), (x, z, y), (y, z, x))):
        n_flops = _cpnet_flops(torch, net, h, w) * n_slices
        views[f"cellpose view {k + 1}"] = {
            "slices": n_slices, "slice": [h, w],
            "s": secs[f"cellpose view {k + 1}"], "tflop": n_flops / 1e12}
        flops += n_flops
    labels = timed("segment_cells_cellpose", lambda: cp.segment_cells_cellpose(
        vol, net, max_cells=SEG_MAX_NUCLEI))
    norm = cp._normalize99(vol)
    finite = bool(torch.isfinite(flow).all() and torch.isfinite(prob).all())
    one = norm.movedim(2, 0)[:1].contiguous()
    f_card, p_card = cp._run_slices(net, one)
    f_cpu, p_cpu = cp._run_slices(copy.deepcopy(net).cpu(), one.cpu())
    err = max(float((f_card.cpu() - f_cpu).abs().max()),
              float((p_card.cpu() - p_cpu).abs().max()))
    view_s = sum(v["s"] for v in views.values())
    rec = {"views": views, "flops": flops, "view_s": view_s,
           "tflops_per_s": flops / view_s / 1e12,
           "share_of_f32_peak": flops / view_s / peaks[1],
           "finite": finite, "cpu_slice_max_abs_err": err,
           "labels": int(labels.max()), "labels_shape": list(labels.shape),
           "out_abs_max": float(flow.abs().max())}
    if not finite or err > 1e-4 or tuple(labels.shape) != (z, x, y):
        raise AssertionError(f"segmentation (e): {rec}")
    print(f"segmentation (e): CPnet {cp.DEFAULT_NBASE} on {tuple(vol.shape)}: "
          f"views {views}; {flops / 1e12:.2f} TFLOP in {view_s:.3f} s = "
          f"{rec['tflops_per_s']:.2f} TFLOP/s f32, "
          f"{100 * rec['share_of_f32_peak']:.1f} % of {peaks[2]}; flows "
          f"finite, one slice within {err:.3g} of the CPU; "
          f"segment_cells_cellpose {rec['labels']} labels  [{smi}]")
    return rec


def _segmentation_phase(torch, smi: str, peaks) -> dict:
    """Phase 12: segmentation on the card at a lab's size.

    The scene (_seg_nuclei, _dapi_scene): phase 10's 8 x 8 grid of
    ellipsoidal nuclei (semi-axes 30 x 70 x 70 px, 256 px apart) in a
    60 x 2048 x 2048 DAPI channel, the SEG_PAIRS positions each holding a
    touching pair (semi-axes 30 x 60 x 60, centres 112 px apart), every
    nucleus of its own brightness (800-1100) with a +-15 % gradient along
    a random xy direction, lognormal speckle (sigma 0.1) over background
    100 and read noise; a polyT channel with a 1.5 x halo.  (a)
    ``segment_nuclei`` (pixel sizes 250 x 108 x 108 nm, sigma 8, seeds 100
    px apart, 128 seeds), ``screen_labels``, ``split_oversized_nuclei``:
    one label a planted nucleus, single nuclei at IoU >= 0.85, each pair in
    two labels (members at IoU >= 0.6), a 60 x 256 x 256 crop's labels on
    the card equal to the port's CPU run.  (b) Those labels through
    ``DaxProcesser._fit_spots_by_segmentation`` on a spot channel planted
    in the same nuclei (phase 10's spots): >= 90 % of planted spots in
    their own cell at a median <= 0.05 px, every kept spot near its mask,
    seed_classify, lm_fit and gather_cubes launched.  (c)
    ``segment_cells`` with the polyT: every nucleus inside its cell, every
    cell inside the halos.  (d) ``init_unet_params`` at full width (2
    channels, base 16, 3 levels), ``fit_unet`` 200 steps on a 60 x 128 x
    128 crop of the (1, 4, 4)-pooled channels, ``segment_fov_learned`` over
    the FOV: >= 90 % of planted nuclei at IoU >= 0.6; ``unet_apply`` on a
    pooled crop equal to the CPU's at atol 1e-4.  (e) cellpose's CPnet at
    the 'nuclei' geometry with seeded random weights: ``cellpose_flows_3d``
    and ``segment_cells_cellpose`` on (d)'s pooled volume padded to 64
    planes, each view timed, the f32 rate from the layer shapes, one slice
    equal to the CPU's at atol 1e-4.  Timed on the host clock around
    ``torch.cuda.synchronize()``."""
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    secs = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    shape = SHAPE
    nuclei, pairs = _seg_nuclei(shape)
    truth, dapi, polyt, halo = timed("scene", lambda: _dapi_scene(
        torch, np.random.default_rng(12), shape, dev, nuclei))
    scene = {"nuclei": nuclei, "pairs": pairs, "truth": truth, "dapi": dapi,
             "polyt": polyt, "halo": halo}
    rec = {"seconds": secs}
    rec["dapi"], labels, best = _seg_dapi(torch, dev, shape, scene, timed,
                                          smi)
    rec["cell_spots"] = _seg_cell_spots(torch, dev, shape, scene, labels,
                                        best, timed, smi)
    rec["launches"] = rec["cell_spots"]["launches"]
    del labels
    torch.cuda.empty_cache()
    rec["cells"] = _seg_cells(torch, dev, scene, timed, smi)
    torch.cuda.empty_cache()
    rec["learned"], pooled = _seg_learned(torch, dev, scene, timed, secs,
                                          smi)
    del scene, truth, dapi, polyt, halo
    torch.cuda.empty_cache()
    rec["cellpose"] = _seg_cellpose(torch, dev, pooled, timed, secs, peaks,
                                    smi)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    print(f"segmentation: phase {rec['phase_seconds']:.1f} s with its CPU "
          f"references; seconds "
          f"{ {k: round(v, 4) for k, v in secs.items()} }; kernel launches "
          f"{rec['launches']}  [{smi}]")
    return rec


#: phase 11's scenes: a population of planted domain traces at phase 9's
#: width, a genome-wide DNA-MERFISH scene, phase 10's nuclei labels and
#: slice 1's bench stack
AN_CHROMS = 2048                   # phase 9's population width
AN_REGIONS = 300
#: chromosomes through the per-chromosome callers: cut from 256 to fit
#: the phase's 45 s (their host loops of small launches take 0.24-0.33 s
#: a chromosome on an H100)
AN_CALL_CHROMS = 48
AN_CPU_CHROMS = 16                 # ... held against the CPU's
AN_SCORE_CPU = 4                   # compartment scores against the CPU
AN_BOOT_CPU = 64                   # bootstrap hits against the CPU
AN_BOOT_ITER = 100
AN_GRID = 30                       # compartment_scores' grid radius
AN_WINDOW = 5                      # the batched sliding window
#: genome-wide scene: chromosomes 1-22 and X at ~1000 loci in all, loci in
#: proportion to each chromosome's length (GRCh38, Mb)
GENOME_MB = (248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
             114, 107, 102, 90, 83, 80, 59, 64, 47, 51, 156)
GENOME_CHRS = tuple(str(i) for i in range(1, 23)) + ("X",)
GENOME_LOCI = 1000
GENOME_CELLS = 500
GENOME_CPU_CELLS = 24              # groups against the CPU's
GENOME_SUMMARY_CPU = (("1", "7", "X"), 50)   # chromosomes x cells
GENOME_CLOUD_CELLS = 8
GENOME_HUB = (("1", 20), ("7", 10), ("14", 5))   # (chr, chr_order)
GENOME_RADIUS_UM = 5.0             # nucleus radius
GENOME_SEARCH_UM = 0.25            # find_interaction_groups' radius
LEGACY_PATH = ("seed_classify", "lm_fit", "gather_cubes")
LEGACY_CROP = (slice(24, 36), slice(0, 256), slice(0, 256))


def _domain_sizes(rng):
    """10-15 domain sizes of 15-40 regions summing to AN_REGIONS."""
    while True:
        sizes = rng.integers(15, 41, 16)
        k = int(np.searchsorted(np.cumsum(sizes), AN_REGIONS))
        sizes = sizes[:k + 1].copy()
        sizes[-1] -= int(sizes.sum()) - AN_REGIONS
        if 10 <= len(sizes) <= 15 and 15 <= sizes[-1] <= 40:
            return sizes


def _domain_population(rng, n, sizes):
    """(n, R, 3) float32 nm traces of compact domain globules (150 nm
    spread about each domain's centre), A and B compartments alternating
    domain by domain (A centres 120 nm about one pole, B about another
    1500 nm away, so domains of one compartment meet), each chromosome moved anywhere in a 10 um box, 10 % of
    the regions NaN; the middle region of the largest domain sits at its
    centre and is never missing -> (traces, starts, region compartment
    (R,), that domain's region indices, its middle region, the middle
    region of a neighbouring domain)."""
    k = len(sizes)
    comp = np.arange(k) % 2
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    dom_of = np.repeat(np.arange(k), sizes)
    poles = np.array([[0.0, 0.0, 0.0], [1500.0, 0.0, 0.0]])
    centres = poles[comp][None] + rng.normal(0, 120.0, (n, k, 3))
    z = centres[:, dom_of] + rng.normal(0, 150.0, (n, AN_REGIONS, 3))
    big = int(np.argmax(sizes))
    dom = np.arange(starts[big], starts[big] + sizes[big])
    mid = int(dom[len(dom) // 2])
    z[:, mid] = centres[:, big]
    near = big + 1 if big + 1 < k else big - 1
    out = int(starts[near] + sizes[near] // 2)
    z += rng.uniform(0, 10000.0, (n, 1, 3))
    missing = rng.uniform(size=(n, AN_REGIONS)) < 0.1
    missing[:, mid] = False
    z[missing] = np.nan
    return z.astype(np.float32), starts, comp[dom_of], dom, mid, out


def _boundary_recall(called, starts) -> float:
    """Share of the planted boundaries (starts but 0) with a called start
    within 2 regions."""
    called = np.asarray(called)
    return float(np.mean([np.abs(called - b).min() <= 2 for b in starts[1:]]))


def _genome_codebook():
    """Column codebook of GENOME_LOCI loci over GENOME_CHRS -> (codebook,
    loci per chromosome)."""
    mb = np.asarray(GENOME_MB, float)
    n = np.maximum(5, np.round(GENOME_LOCI * mb / mb.sum())).astype(int)
    chrs = np.concatenate([[c] * k for c, k in zip(GENOME_CHRS, n)])
    return ({"id": np.arange(len(chrs)), "chr": chrs.astype("U2"),
             "chr_order": np.concatenate([np.arange(k) for k in n])},
            dict(zip(GENOME_CHRS, (int(k) for k in n))))


def _genome_cells(rng, n_cells, sizes):
    """Per-cell dicts chr -> (H, R_chr, 3) um traces (2 homologs, X one):
    each homolog a random walk of 0.8 um steps about a territory centre
    inside a GENOME_RADIUS_UM nucleus, 10 % of loci NaN; every other cell
    carries a hub of GENOME_HUB's three loci (homolog 0) within 0.03 um of
    one point -> (cells, the cells carrying a hub)."""
    cells = []
    for k in range(n_cells):
        cell = {}
        for c in GENOME_CHRS:
            h = 1 if c == "X" else 2
            v = rng.normal(size=(h, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            centre = v * 0.6 * GENOME_RADIUS_UM \
                * rng.uniform(size=(h, 1)) ** (1 / 3)
            tr = np.cumsum(rng.normal(0, 0.8 / np.sqrt(3),
                                      (h, sizes[c], 3)), 1)
            tr += centre[:, None] - tr.mean(1, keepdims=True)
            tr[rng.uniform(size=tr.shape[:2]) < 0.1] = np.nan
            cell[c] = tr.astype(np.float32)
        if k % 2 == 0:
            hub = rng.uniform(-2.0, 2.0, 3)
            for c, o in GENOME_HUB:
                cell[c][0, o] = hub + rng.normal(0, 0.03, 3)
        cells.append(cell)
    return cells, np.arange(0, n_cells, 2)


def _cell_table_numpy(labels: np.ndarray, shape) -> dict:
    """The cell-location table of the planted nuclei by NumPy on the host:
    each nucleus' voxel counts per plane, row and column of its planted
    box give its volume, its coordinate sums (exact integers) and its
    bounds; the boxes together must hold every labelled voxel of the
    volume (so none lies outside its nucleus' box)."""
    size = np.asarray(shape, float)
    px_um = np.asarray([200.0, 108.0, 108.0]) / 1000.0
    rows = []
    for cid, c in _nucleus_centres(shape):
        lo, hi = _nucleus_box(c, shape)
        mask = labels[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] == cid
        n = int(mask.sum())
        sums, mins, maxs = [], [], []
        for ax in range(3):
            per = mask.sum(axis=tuple(a for a in range(3) if a != ax))
            at = np.arange(lo[ax], hi[ax])
            hit = at[per > 0]
            sums.append(float((per * at).sum()))
            mins.append(float(hit.min()))
            maxs.append(float(hit.max()))
        rows.append((cid, n, (np.asarray(sums) / n - size / 2) * px_um,
                     (np.asarray(mins) - size / 2) * px_um,
                     (np.asarray(maxs) + 1 - size / 2) * px_um))
    if sum(r[1] for r in rows) != np.count_nonzero(labels):
        raise AssertionError("cell locations: labelled voxels outside the "
                             "planted nuclei's boxes")
    out = {"cell_id": np.asarray([r[0] for r in rows]),
           "volume": np.asarray([r[1] for r in rows])}
    for name, k in (("center", 2), ("min", 3), ("max", 4)):
        for i, a in enumerate("zxy"):
            out[f"{name}_{a}"] = np.asarray([r[k][i] for r in rows])
    return out


def _bootstrap_hits(torch, dm, spots, subsets, tol=1e-3, fw_iters=64):
    """Every bootstrap sample's hull distance as
    ``postanalysis.bootstrap_probs`` forms it, a lower bound of the true
    distance certified by the Frank-Wolfe gap at the last iterate (f(w) -
    f* <= gap for f = |x - p|^2 / 2, in float64), and the cut -> ((C, S)
    distances, (C, S) lower bounds, (C,) cuts).  A sample whose cut lies
    between its bound and its distance is undecided after `fw_iters`
    iterations: a device's rounding can put it on either side."""
    from imageanalysis3_tpu_torch.analysis import postanalysis as pa

    base = (~torch.isnan(dm).any(-1) & ~(dm == spots[:, None]).all(-1))
    pts = torch.nan_to_num(dm)
    d = pts - spots[:, None]
    radius = torch.where(base, torch.sqrt(d[..., 0] * d[..., 0]
                                          + d[..., 1] * d[..., 1]
                                          + d[..., 2] * d[..., 2]), 0.0)
    cut = tol * radius.amax(dim=1).clamp_min(1.0)
    chosen = torch.zeros(subsets.shape[:2] + (dm.shape[1],),
                         dtype=torch.bool, device=dm.device)
    chosen.scatter_(-1, subsets, True)
    valid = chosen & base[:, None]
    masked = torch.where(valid[..., None], pts[:, None], 0.0)
    p = spots[:, None].expand(-1, subsets.shape[1], -1)
    dist = pa._hull_distance(masked, valid, p, fw_iters)
    x = pa._frank_wolfe(masked, valid, p, fw_iters)
    r = (x - p).double()
    rel = masked.double() - p.double()[..., None, :]
    g = (rel @ r[..., :, None])[..., 0]
    gap = (r * r).sum(-1) - torch.where(valid, g, float("inf")).amin(-1)
    lo = torch.sqrt(((r * r).sum(-1) - 2.0 * gap).clamp_min(0.0))
    return dist, lo.float(), cut


def _analysis_population(torch, dev, timed, smi: str) -> dict:
    """Phase 11 (a): population, domains and compartments (see
    _analysis_phase)."""
    from imageanalysis3_tpu_torch import analysis as an
    from imageanalysis3_tpu_torch.analysis import (compartments, distmap,
                                                   domains, postanalysis)

    rng = np.random.default_rng(43)
    sizes = _domain_sizes(rng)
    z, starts, comp, dom, mid, out_region = _domain_population(
        rng, AN_CHROMS, sizes)
    rec = {"domains": len(sizes), "sizes": sizes.tolist()}
    zt = torch.as_tensor(z, device=dev)
    valid = torch.isfinite(zt).all(dim=-1)

    # population maps and the A/B eigenscore
    med = timed("median_distance_map",
                lambda: distmap.median_distance_map(zt))
    ev = timed("ab_compartment_eigenscore",
               lambda: an.ab_compartment_eigenscore(med)).cpu().numpy()
    ok = np.isfinite(ev)
    agree = float(np.mean((ev[ok] > 0) == (comp[ok] == 0)))
    rec["eigenscore_sign_agreement"] = max(agree, 1 - agree)
    ev_cpu = an.ab_compartment_eigenscore(med.cpu(), device="cpu").numpy()
    rec["eigenscore_signs_differ_from_cpu"] = int(
        (np.sign(ev_cpu[ok]) != np.sign(ev[ok])).sum())
    if rec["eigenscore_sign_agreement"] < 0.9:
        raise AssertionError(f"analysis (a): eigenscore signs match the "
                             f"planted A/B on {rec['eigenscore_sign_agreement']}"
                             f" of the regions")

    # the batched boundary signal
    dms = distmap.distance_map(zt)
    sw = timed("sliding_window_dist", lambda: an.sliding_window_dist(
        dms, AN_WINDOW, valid=valid))
    cpu_sw = an.sliding_window_dist(dms[:AN_SCORE_CPU].cpu(), AN_WINDOW,
                                    valid=valid[:AN_SCORE_CPU].cpu(),
                                    device="cpu")
    rec["sliding_window_max_abs_err"] = float(
        (sw[:AN_SCORE_CPU].cpu() - cpu_sw).abs().max())
    if not torch.allclose(sw[:AN_SCORE_CPU].cpu(), cpu_sw, rtol=1e-4,
                          atol=1e-5):
        raise AssertionError(f"analysis (a): the batched sliding window "
                             f"differs from the CPU's by "
                             f"{rec['sliding_window_max_abs_err']}")
    del dms

    # compartment scores on the normalised clouds (1 grid unit = 100 nm)
    a_mask = torch.as_tensor(comp == 0, device=dev)
    norm = timed("normalize_center_spots",
                 lambda: compartments.normalize_center_spots(
                     zt, valid, True, 0.01))
    scores = timed("compartment_scores", lambda: an.compartment_scores(
        norm, valid, a_mask, ~a_mask, grid_radius=AN_GRID))
    sc = scores.cpu().numpy()
    rec["mean_score_a"] = float(np.nanmean(sc[:, comp == 0]))
    rec["mean_score_b"] = float(np.nanmean(sc[:, comp == 1]))
    if not rec["mean_score_a"] > rec["mean_score_b"]:
        raise AssertionError(f"analysis (a): compartment scores A "
                             f"{rec['mean_score_a']} <= B "
                             f"{rec['mean_score_b']}")
    k = AN_SCORE_CPU
    norm_cpu = compartments.normalize_center_spots(
        zt[:k].cpu(), valid[:k].cpu(), True, 0.01, device="cpu")
    nc = norm[:k].cpu()
    sign = torch.sign(torch.nansum(norm_cpu * nc, dim=-2, keepdim=True))
    rec["normalize_max_abs_err"] = float(torch.nan_to_num(
        (nc * sign - norm_cpu).abs()).max())
    sc_cpu = an.compartment_scores(nc, valid[:k].cpu(), a_mask.cpu(),
                                   ~a_mask.cpu(), grid_radius=AN_GRID,
                                   device="cpu").numpy()
    rec["scores_max_abs_err"] = float(np.nanmax(np.abs(sc[:k] - sc_cpu)))
    if (not torch.allclose(nc * sign, norm_cpu, rtol=1e-4, atol=1e-4,
                           equal_nan=True)
            or not np.allclose(sc[:k], sc_cpu, rtol=1e-4, atol=1e-5,
                               equal_nan=True)):
        raise AssertionError(f"analysis (a): normalised clouds or scores "
                             f"differ from the CPU's: {rec}")
    del norm, scores

    # bootstrap enclosure of a region at its domain's centre and of one in
    # the next domain, over all chromosomes
    n_dom = len(dom)
    k_sub = postanalysis._sampling_size(n_dom, 0.5)
    subsets = postanalysis.draw_bootstrap_subsets(
        AN_CHROMS, AN_BOOT_ITER, n_dom, k_sub, seed=43).to(dev)
    pts = zt[:, torch.as_tensor(dom, device=dev)]
    p_in = timed("bootstrap", lambda: postanalysis.bootstrap_probs(
        pts, zt[:, mid], subsets))
    p_out = timed("bootstrap", lambda: postanalysis.bootstrap_probs(
        pts, zt[:, out_region], subsets))
    wrapped = an.bootstrap_regions_in_domain(
        zt, mid, dom, p_bootstrap=0.5, n_iter=AN_BOOT_ITER, seed=43)
    rec["bootstrap"] = {"domain_size": n_dom, "sampling_size": k_sub,
                        "inside": float(torch.nanmean(p_in)),
                        "outside": float(torch.nanmean(p_out)),
                        "wrapper_equal": bool(torch.equal(
                            torch.nan_to_num(wrapped, -1.0),
                            torch.nan_to_num(p_in, -1.0)))}
    undecided, flips = 0, 0
    for spot_region in (mid, out_region):
        sl = slice(0, AN_BOOT_CPU)
        args = (pts[sl], zt[sl, spot_region], subsets[sl])
        d_card, lo_card, cut = _bootstrap_hits(torch, *args)
        d_cpu, lo_cpu, cut_cpu = _bootstrap_hits(torch,
                                                 *(a.cpu() for a in args))
        rate = (d_card < cut[:, None]).to(torch.float32).mean(1).cpu()
        d_card, lo_card, cut = d_card.cpu(), lo_card.cpu(), cut.cpu()
        hit_card = d_card < cut[:, None]
        hit_cpu = d_cpu < cut_cpu[:, None]
        open_card = (lo_card <= cut[:, None]) & ~hit_card
        open_cpu = (lo_cpu <= cut_cpu[:, None]) & ~hit_cpu
        differ = hit_card != hit_cpu
        undecided += int((open_card | open_cpu).sum())
        flips += int(differ.sum())
        if (differ & ~(open_card | open_cpu)).any():
            bad = differ & ~(open_card | open_cpu)
            raise AssertionError(
                f"analysis (a): bootstrap hits differ from the CPU's where "
                f"both are decided: card {d_card[bad][:8]} (bound "
                f"{lo_card[bad][:8]}), CPU {d_cpu[bad][:8]} (bound "
                f"{lo_cpu[bad][:8]}), cut {cut[:, None].expand_as(bad)[bad][:8]}")
        probs = postanalysis.bootstrap_probs(*args).cpu()
        ok_spot = ~torch.isnan(probs)
        if not torch.equal(probs[ok_spot], rate[ok_spot]):
            raise AssertionError("analysis (a): bootstrap_probs is not its "
                                 "samples' hit rate")
    rec["bootstrap"]["undecided_samples"] = undecided
    rec["bootstrap"]["hits_differing_from_cpu"] = flips
    if not (rec["bootstrap"]["inside"] >= 0.8
            and rec["bootstrap"]["outside"] <= 0.2
            and rec["bootstrap"]["wrapper_equal"]):
        raise AssertionError(f"analysis (a): bootstrap {rec['bootstrap']}")

    # the per-chromosome callers
    print(f"analysis (a): per-chromosome callers on {AN_CALL_CHROMS} of "
          f"{AN_CHROMS} chromosomes (cut from 256 to fit the phase's "
          f"budget), {AN_CPU_CHROMS} against the CPU")
    callers = {
        "basic": lambda t: an.basic_domain_calling(t),
        "iterative": lambda t: an.iterative_domain_calling(t),
        "insulation": lambda t: an.insulation_domain_calling(
            distmap.distance_map(t)),
        "sliding_window": lambda t: an.sliding_window_domain_calling(t),
        "interdomain": lambda t: an.iterative_interdomain_calling(
            distmap.distance_map(t), starts)}
    called = {name: [] for name in callers}
    for c in range(AN_CALL_CHROMS):
        for name, fn in callers.items():
            called[name].append(timed(name, lambda: fn(zt[c])))
    recall = {name: float(np.median([_boundary_recall(s, starts)
                                     for s in called[name]]))
              for name in callers if name != "interdomain"}
    rec["median_boundary_recall"] = recall
    dom_comp = comp[starts]
    pairs_all = [p for ps in called["interdomain"] for p in ps]
    rec["interdomain_pairs_per_chromosome"] = len(pairs_all) / AN_CALL_CHROMS
    rec["interdomain_same_compartment"] = float(np.mean(
        [dom_comp[a] == dom_comp[b] for a, b in pairs_all])) \
        if pairs_all else float("nan")
    rec["callers_chromosomes"] = AN_CALL_CHROMS
    differ = []
    zc = zt[:AN_CPU_CHROMS].cpu()
    for c in range(AN_CPU_CHROMS):
        for name, fn in callers.items():
            cpu = fn(zc[c])
            if name == "interdomain":
                if cpu != called[name][c]:
                    print(f"analysis (a): chromosome {c} interdomain pairs "
                          f"differ: card {called[name][c]}, CPU {cpu}")
                    differ.append(c)
                continue
            if not np.array_equal(cpu, called[name][c]):
                metric, w = (("insulation", 2 * AN_WINDOW)
                             if name == "insulation" else ("median",
                                                           AN_WINDOW))
                sig = [domains.sliding_window_dist(
                    distmap.distance_map(t), w, metric,
                    valid=None if name == "insulation"
                    else torch.isfinite(t).all(-1)) for t in (zt[c], zc[c])]
                at = np.setxor1d(cpu, called[name][c])
                gap = (sig[0].cpu() - sig[1]).abs().max()
                print(f"analysis (a): chromosome {c} {name} starts differ: "
                      f"card {called[name][c].tolist()}, CPU {cpu.tolist()};"
                      f" signal at {at.tolist()} card "
                      f"{sig[0].cpu()[at].tolist()} CPU "
                      f"{sig[1][at].tolist()}, max |card - CPU| {gap:.3g}")
                differ.append(c)
    rec["chromosomes_differing_from_cpu"] = sorted(set(differ))
    if recall["basic"] < 0.8 or recall["iterative"] < 0.8:
        raise AssertionError(f"analysis (a): boundary recall {recall}")
    if len(set(differ)) > 1:
        raise AssertionError(f"analysis (a): {len(set(differ))} of "
                             f"{AN_CPU_CHROMS} chromosomes' starts differ "
                             f"from the CPU's")

    # interactions and loop-outs on the median map
    pairs = timed("iterative_interdomain_calling",
                  lambda: an.iterative_interdomain_calling(med, starts))
    loops = timed("loop_out_scores", lambda: an.loop_out_scores(med, starts))
    calls = timed("call_loop_outs", lambda: an.call_loop_outs(med, starts))
    med_cpu = med.cpu()
    pairs_cpu = an.iterative_interdomain_calling(med_cpu, starts,
                                                 device="cpu")
    loops_cpu = an.loop_out_scores(med_cpu, starts, device="cpu")
    calls_cpu = an.call_loop_outs(med_cpu, starts, device="cpu")
    rec["median_map_interdomain_pairs"] = pairs
    rec["median_map_loop_outs"] = len(calls)
    if (pairs != pairs_cpu or calls != calls_cpu
            or not torch.allclose(loops.cpu(), loops_cpu, rtol=1e-10,
                                  atol=1e-12, equal_nan=True)):
        raise AssertionError(f"analysis (a): interactions or loop-outs "
                             f"differ from the CPU's: {pairs} / {pairs_cpu}")
    if rec["eigenscore_signs_differ_from_cpu"]:
        raise AssertionError(f"analysis (a): eigenscore signs differ from "
                             f"the CPU's at "
                             f"{rec['eigenscore_signs_differ_from_cpu']} "
                             f"regions")
    return rec


def _analysis_genome(torch, dev, timed, smi: str) -> dict:
    """Phase 11 (b): genome-wide summaries, hubs and clouds (see
    _analysis_phase)."""
    from imageanalysis3_tpu_torch import analysis as an

    rng = np.random.default_rng(44)
    codebook, sizes = _genome_codebook()
    cells, hub_cells = _genome_cells(rng, GENOME_CELLS, sizes)
    rec = {"loci": len(codebook["id"]), "cells": GENOME_CELLS,
           "hub_cells": len(hub_cells)}
    torch.cuda.reset_peak_memory_stats()
    summary = timed("genome_summary_dict", lambda: an.genome_summary_dict(
        cells, codebook, device=dev))
    matrix, edges, names = timed("assemble_dist_dict_to_matrix",
                                 lambda: an.assemble_dist_dict_to_matrix(
                                     summary, codebook, device=dev))
    rec["summary_entries"] = len(summary)
    rec["matrix_finite"] = float(torch.isfinite(matrix).float().mean())
    if matrix.shape != (len(codebook["id"]),) * 2 or len(names) != 23:
        raise AssertionError(f"analysis (b): matrix {tuple(matrix.shape)}, "
                             f"{len(names)} chromosomes")
    keep, n_cpu = GENOME_SUMMARY_CPU
    sel = np.isin(codebook["chr"], keep)
    sub_book = {k: v[sel] for k, v in codebook.items()}
    sub_cells = [{c: cell[c] for c in keep} for cell in cells[:n_cpu]]
    card = an.genome_summary_dict(sub_cells, sub_book, device=dev)
    cpu = an.genome_summary_dict(sub_cells, sub_book, device="cpu")
    for key in cpu:
        if not torch.allclose(card[key].cpu(), cpu[key], rtol=1e-5,
                              atol=1e-6, equal_nan=True):
            raise AssertionError(f"analysis (b): summary {key} differs from "
                                 f"the CPU's")
    hub_ids = {int(np.nonzero((codebook["chr"] == c)
                              & (codebook["chr_order"] == o))[0][0])
               for c, o in GENOME_HUB}
    found, n_groups, groups = 0, 0, []
    for k, cell in enumerate(cells):
        out = timed("find_interaction_groups",
                    lambda: an.find_interaction_groups(
                        cell, codebook, search_radius=GENOME_SEARCH_UM,
                        device=dev))
        n_groups += len(out[1])
        if k < GENOME_CPU_CELLS:
            groups.append(out)
        if k % 2 == 0:
            found += any(hub_ids <= set(map(int, g)) for g in out[1])
    rec["hubs_found"] = found / len(hub_cells)
    rec["groups_per_cell"] = n_groups / GENOME_CELLS
    for k in range(GENOME_CPU_CELLS):
        cpu = an.find_interaction_groups(cells[k], codebook,
                                         search_radius=GENOME_SEARCH_UM,
                                         device="cpu")
        if {tuple(g) for g in cpu[1]} != {tuple(g) for g in groups[k][1]}:
            raise AssertionError(f"analysis (b): cell {k}'s groups differ "
                                 f"from the CPU's")
    clouds = [timed("chr_to_density_clouds", lambda: an.chr_to_density_clouds(
        cell, device=dev)) for cell in cells[:GENOME_CLOUD_CELLS]]
    rec["clouds_per_cell"] = [sum(v.shape[0] for v in c.values())
                              for c in clouds]
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del clouds, summary, matrix
    if rec["hubs_found"] < 0.9:
        raise AssertionError(f"analysis (b): hubs found in "
                             f"{rec['hubs_found']} of the cells carrying one")
    return rec


def _analysis_cells(torch, dev, timed, smi: str) -> dict:
    """Phase 11 (c): cell locations of phase 10's nuclei (see
    _analysis_phase)."""
    from imageanalysis3_tpu_torch.analysis import cell_locations as cl

    labels = timed("nuclei_labels", lambda: _nuclei_labels(torch, SHAPE,
                                                           dev))
    table = timed("segmentation_to_cell_locations",
                  lambda: cl.segmentation_to_cell_locations(labels,
                                                            fov_id=0))
    host = timed("labels_to_host", lambda: labels.cpu().numpy())
    del labels
    want = timed("cell_table_numpy", lambda: _cell_table_numpy(host, SHAPE))
    for c in ("cell_id", "volume") + tuple(f"{n}_{a}" for n in ("min", "max")
                                           for a in "zxy"):
        if not np.array_equal(table[c], want[c]):
            raise AssertionError(f"analysis (c): column {c} differs from "
                                 f"NumPy's")
    err = max(float(np.abs(table[f"center_{a}"] - want[f"center_{a}"]).max())
              for a in "zxy")
    if err > 1e-9:
        raise AssertionError(f"analysis (c): centres differ by {err}")
    # two FOVs whose grids overlap by one column of nuclei
    pitch_um = CELL_PITCH * (CELL_GRID - 1) * 0.108
    pos = [(0.0, 500.0, 800.0), (0.0, 500.0, 800.0 + pitch_um)]
    fovs = [timed("translate_cell_locations",
                  lambda: cl.translate_cell_locations(table, p))
            for p in pos]
    merged = timed("merge_cell_locations",
                   lambda: cl.merge_cell_locations(fovs, device=dev))
    n = len(table["cell_id"])
    ids_b = merged["cell_id"][n:]
    overlap = np.asarray([cid for cid, _ in _nucleus_centres(SHAPE)
                          if (cid - 1) % CELL_GRID == 0])
    rec = {"cells": n, "centre_max_abs_err": err,
           "merged": len(merged["cell_id"]),
           "dropped": sorted(int(c) for c in set(table["cell_id"])
                             - set(ids_b))}
    if rec["dropped"] != overlap.tolist() or rec["merged"] != 2 * n \
            - len(overlap):
        raise AssertionError(f"analysis (c): the merge dropped "
                             f"{rec['dropped']}, want {overlap.tolist()}")
    return rec


def _fit_gate(torch, label, centers, truth) -> dict:
    """bench.py's gate on fitted centres (N, 3): median error over the
    first 500 truths matched within 1 px <= 0.02 px, n_valid >= 90 % of
    the planted spots."""
    got = torch.as_tensor(np.asarray(centers, np.float32))
    errs, n_match = _matched_errors(torch, got, truth[:500])
    med = float(np.median(errs)) if len(errs) else float("nan")
    n_val = int(len(got))
    if not med <= 0.02 or n_val < int(np.ceil(0.9 * len(truth))):
        raise AssertionError(f"analysis (d) {label}: median_centroid_err_px "
                             f"{med} over {n_match}, n_valid {n_val}")
    return {"median_centroid_err_px": med, "matched": n_match,
            "n_valid": n_val}


def _rows_agree(label, card, cpu):
    """Fitted rows of the card and the CPU at the fit tolerances of
    tests/test_torch_fit.py: centres and widths 1e-3 px, heights rtol
    1e-2; raises otherwise."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    if card.shape != cpu.shape:
        raise AssertionError(f"analysis (d) {label}: card {card.shape} "
                             f"against CPU {cpu.shape}")
    if card.size == 0:
        return 0.0
    if card.shape[-1] == 3:
        err = float(np.abs(card - cpu).max())
        if err > 1e-3:
            raise AssertionError(f"analysis (d) {label}: centres differ by "
                                 f"{err}")
        return err
    err = float(np.abs(card[:, 1:4] - cpu[:, 1:4]).max())
    ok = (err <= 1e-3
          and np.allclose(card[:, 0], cpu[:, 0], rtol=1e-2)
          and np.allclose(card[:, 5:8], cpu[:, 5:8], rtol=0, atol=1e-3))
    if not ok:
        raise AssertionError(f"analysis (d) {label}: rows differ from the "
                             f"CPU's beyond the fit tolerances")
    return err


def _analysis_ops(torch, dev, timed, peaks, smi: str) -> dict:
    """Phase 11 (d): the rest of ops/ on slice 1's bench stack (see
    _analysis_phase)."""
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.ops import (
        fit_matched_centers, fit_multi_gaussian, fit_seed_points_base,
        fitsinglegaussian_fixed_width, gather_kernel, get_seed_points_base,
        get_STD_centers, kernel_launches, reset_kernel_launches)

    rng = np.random.default_rng(0)
    truth = syn.sample_spot_params(SHAPE, N_SPOTS, rng, min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    centers = truth["centers"]
    base = syn.render_spots(SHAPE, centers, truth["heights"],
                            background=truth["background"], device=dev)
    ims = [syn.noisy_uint16(base, seed=70 + k).to(torch.float32)
           for k in range(2)]
    del base
    im = ims[0]
    rec = {"launches": {}}

    def counted(name, fn, warm=True):
        if warm:
            fn()                                 # untimed first call
        torch.cuda.synchronize()
        reset_kernel_launches()
        out = timed(name, fn)
        rec["launches"][name] = kernel_launches()
        return out

    pairs = counted("fit_matched_centers", lambda: fit_matched_centers(
        im, centers, th_seed=TH_SEED, max_num_seeds=2048))
    rec["fit_matched_centers"] = {"pairs": int(pairs.n_pairs),
                                  "share": int(pairs.n_pairs) / len(centers)}
    if rec["fit_matched_centers"]["share"] < 0.9:
        raise AssertionError(f"analysis (d): fit_matched_centers matched "
                             f"{rec['fit_matched_centers']}")
    std = counted("get_STD_centers", lambda: get_STD_centers(
        im, th_seed=TH_SEED, max_num_seeds=2048))
    rec["get_STD_centers"] = _fit_gate(torch, "get_STD_centers", std,
                                       centers)
    seeds = timed("get_seed_points_base", lambda: get_seed_points_base(
        im, th_seed=TH_SEED, max_num_seeds=2048))
    rows = counted("fit_multi_gaussian", lambda: fit_multi_gaussian(
        im, seeds.T))
    rec["seeds"] = int(seeds.shape[1])
    rec["fit_multi_gaussian"] = _fit_gate(torch, "fit_multi_gaussian",
                                          rows[:, 1:4], centers)
    s64 = seeds[:, :64]
    base_rows = counted("fit_seed_points_base",
                        lambda: fit_seed_points_base(im, s64))
    singles = counted("fitsinglegaussian_fixed_width", lambda: [
        fitsinglegaussian_fixed_width(im, s64[:, k], radius=5)[0]
        for k in range(64)], warm=False)
    rec["fit_seed_points_base_finite"] = bool(np.isfinite(base_rows).all())
    rec["fitsinglegaussian_finite"] = bool(all(
        p is not None and np.isfinite(p).all() for p in singles))
    for name in ("fit_matched_centers", "get_STD_centers",
                 "fit_multi_gaussian"):
        for k in LEGACY_PATH:
            if name == "fit_multi_gaussian" and k == "seed_classify":
                continue
            if rec["launches"][name][k] < 1:
                raise AssertionError(f"analysis (d): {k} did not launch in "
                                     f"{name}: {rec['launches'][name]}")
    if not (rec["fit_seed_points_base_finite"]
            and rec["fitsinglegaussian_finite"]):
        raise AssertionError(f"analysis (d): non-finite legacy fits")

    # the card against the CPU on a crop
    crop = im[LEGACY_CROP]
    lo = np.asarray([s.start for s in LEGACY_CROP], float)
    hi = np.asarray([s.stop for s in LEGACY_CROP], float)
    inside = centers[((centers >= lo) & (centers < hi)).all(1)] - lo
    cc = crop.cpu()
    errs = {}
    pc = fit_matched_centers(crop, inside, th_seed=TH_SEED,
                             max_num_seeds=256)
    pp = fit_matched_centers(cc, inside, th_seed=TH_SEED, max_num_seeds=256,
                             device="cpu")
    m = pc.mask.cpu()
    if not torch.equal(m, pp.mask):
        raise AssertionError("analysis (d): fit_matched_centers pairs "
                             "differ from the CPU's on the crop")
    errs["fit_matched_centers"] = _rows_agree(
        "fit_matched_centers", pc.tar.cpu()[m], pp.tar[m])
    errs["get_STD_centers"] = _rows_agree(
        "get_STD_centers", get_STD_centers(crop, th_seed=TH_SEED,
                                           max_num_seeds=256),
        get_STD_centers(cc, th_seed=TH_SEED, max_num_seeds=256,
                        device="cpu"))
    crop_seeds = get_seed_points_base(cc, th_seed=TH_SEED, device="cpu")
    rec["crop_seeds_equal"] = bool(np.array_equal(
        crop_seeds, get_seed_points_base(crop, th_seed=TH_SEED)))
    errs["fit_multi_gaussian"] = _rows_agree(
        "fit_multi_gaussian", fit_multi_gaussian(crop, crop_seeds.T),
        fit_multi_gaussian(cc, crop_seeds.T, device="cpu"))
    errs["fit_seed_points_base"] = _rows_agree(
        "fit_seed_points_base", fit_seed_points_base(crop, crop_seeds[:, :16]),
        fit_seed_points_base(cc, crop_seeds[:, :16], device="cpu"))
    errs["fitsinglegaussian_fixed_width"] = _rows_agree(
        "fitsinglegaussian_fixed_width",
        fitsinglegaussian_fixed_width(crop, crop_seeds[:, 0])[0][None],
        fitsinglegaussian_fixed_width(cc, crop_seeds[:, 0],
                                      device="cpu")[0][None])
    rec["crop"] = {"truth": len(inside), "seeds": int(crop_seeds.shape[1]),
                   "max_centre_err": errs}

    # kernels at launch shapes no earlier phase makes: lm_fit at 2048 seeds
    # x 30 iterations (get_centers' default) and its refit; the ball gather
    # at 64 seeds and at one seed of radius 10 on the full stack
    sets = [(x, *_planted_seeds(torch, centers, 2048, dev)) for x in ims]
    rec["lm_fit"] = _lm_time_case(torch, "legacy round 0", sets, 5, 30,
                                  True, peaks, smi)
    gshapes = {}
    for label, n, radius in (("64 seeds", 64, 5), ("1 seed r10", 1, 10)):
        seeds_n = [torch.as_tensor(np.round(centers[k * n:(k + 1) * n])
                                   .astype(np.float32), device=dev)
                   for k in range(3)]
        for s in seeds_n:
            a = gather_kernel.gather_ball_cuda(im, s, radius)
            b = gather_kernel.gather_ball_plain(im, s, radius)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"analysis (d): gather {label} differs "
                                     f"from its plain version")
        ms = _events_ms(torch, lambda s: gather_kernel.gather_ball_cuda(
            im, s, radius), [(s,) for s in seeds_n], queue_ahead=True)
        plain = _events_ms(torch, lambda s: gather_kernel.gather_ball_plain(
            im, s, radius), [(s,) for s in seeds_n], queue_ahead=False)
        p = gather_kernel.ball_offsets(radius).shape[0]
        bound = _bound(n * p * (4 + 4 + 12 + 1) + 12 * (n + p), 0.0, peaks)
        gshapes[label] = {"ms": ms, "plain_ms": plain, "px": p,
                          "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"gather ball {label}: PASS equal; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound[0]:.5f} ms  [{smi}]")
    rec["gather"] = gshapes
    return rec


def _analysis_phase(torch, smi: str, peaks) -> dict:
    """Phase 11: polymer post-analysis and the rest of ops/ on the card.

    (a) A population of AN_CHROMS chromosomes x AN_REGIONS regions of
    10-15 planted domain globules (15-40 regions each), compartments A and
    B alternating, 10 % of regions missing (_domain_population, seed 43):
    ``median_distance_map`` -> ``ab_compartment_eigenscore`` (signs match
    the planted A/B on >= 90 % of the valid regions), ``sliding_window_dist``
    batched, ``normalize_center_spots`` + ``compartment_scores`` at grid
    radius 30 (mean score on A above B; the first AN_SCORE_CPU against the
    CPU at rtol 1e-4), ``bootstrap_probs`` / ``bootstrap_regions_in_domain``
    (100 samples, 64 Frank-Wolfe iterations) for a region at its domain's
    centre (>= 0.8) and one in the next domain (<= 0.2), the same subsets on
    the CPU for AN_BOOT_CPU chromosomes giving equal hits except where the
    cut lies within a sample's Frank-Wolfe certificate (_bootstrap_hits;
    counted); basic, iterative, insulation and
    sliding-window domain calling and ``iterative_interdomain_calling`` on
    each chromosome's own map, for the first AN_CALL_CHROMS chromosomes
    (median share of planted boundaries with a called start within 2
    regions >= 0.8 for basic and iterative; the first AN_CPU_CHROMS equal
    to the CPU's, at most one chromosome differing, each difference printed
    with the boundary signal there); ``iterative_interdomain_calling``,
    ``loop_out_scores`` and ``call_loop_outs`` on the median map, and the
    eigenscore's signs, equal to the CPU's.  (b) A genome-wide scene
    (_genome_codebook, _genome_cells, seed 44): ``genome_summary_dict``
    over every chromosome pair, ``assemble_dist_dict_to_matrix``,
    ``find_interaction_groups`` per cell (the planted hub found in >= 90 %
    of the cells carrying one; the first GENOME_CPU_CELLS cells' groups
    equal to the CPU's as sets), ``chr_to_density_clouds`` for
    GENOME_CLOUD_CELLS cells; the summary of 3 chromosomes x 50 cells
    against the CPU at rtol 1e-5; peak device memory.  (c) Phase 10's
    nuclei label volume: ``segmentation_to_cell_locations`` equal to a
    NumPy run (volumes and boxes exactly, centres to 1e-9), then
    ``translate_cell_locations`` and ``merge_cell_locations`` for two FOVs
    overlapping by one column of nuclei, which the merge drops exactly.
    (d) Slice 1's bench stack (no vignette): ``fit_matched_centers`` (>= 90
    % of the planted spots paired), ``get_STD_centers`` and
    ``fit_multi_gaussian`` (on ``get_seed_points_base``'s seeds) under
    bench.py's gate, ``fit_seed_points_base`` and
    ``fitsinglegaussian_fixed_width`` on 64 seeds, each entry's kernel
    launches counted from 0 (seed_classify, lm_fit and gather_cubes must
    launch in the first three, the seeding kernel where the entry seeds);
    the same entries on a 12x256x256 crop equal to the CPU's at the fit
    tolerances; lm_fit and the ball gather timed at the launch shapes no
    earlier phase makes.  Timed on the host clock around
    ``torch.cuda.synchronize()``."""
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    secs = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    rec = {"seconds": secs}
    steps = (("population", lambda: _analysis_population(torch, dev, timed,
                                                         smi)),
             ("genome", lambda: _analysis_genome(torch, dev, timed, smi)),
             ("cells", lambda: _analysis_cells(torch, dev, timed, smi)),
             ("ops", lambda: _analysis_ops(torch, dev, timed, peaks, smi)))
    for name, step in steps:
        t0 = time.perf_counter()
        rec[name] = step()
        rec[name]["step_seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"analysis ({name}): {rec[name]['step_seconds']:.1f} s with "
              f"its CPU references; "
              f"{ {k: v for k, v in rec[name].items() if k != 'lm_fit'} }"
              f"  [{smi}]")
    rec["launches"] = {
        k: sum(v[k] for v in rec["ops"]["launches"].values())
        for k in LEGACY_PATH}
    rec["phase_seconds"] = time.perf_counter() - t_phase
    print(f"analysis: phase {rec['phase_seconds']:.1f} s; seconds "
          f"{ {k: round(v, 4) for k, v in secs.items()} }; kernel launches "
          f"{rec['launches']}  [{smi}]")
    return rec


#: the parallel phase: rounds of its data-parallel check, .dax files of its
#: prefetcher check, the drift planted in its sharded round
PAR_ROUNDS = 2
PAR_FILES = 3
PAR_SHIFT = DAX_SHIFT
#: PR 10's pageable upload of a 3-channel 60x2048x2048 round (PERF.md §5)
PR10_UPLOAD = "~0.22 s of a 0.33 s file round (pageable)"


def _require_launches(label, counts, names, at_least=1):
    """Raise unless every kernel in `names` launched `at_least` times."""
    low = {n: counts[n] for n in names if counts[n] < at_least}
    if low:
        raise AssertionError(f"{label}: kernels launched too few times "
                             f"({low}, need {at_least}): {counts}")


def _parallel_phase(torch, smi: str, dev, shape=SHAPE, n_spots=N_SPOTS,
                    device_type="cuda") -> dict:
    """Phase 13: ``parallel/`` on one card, under a world-size-1 group that
    the phase creates (NCCL on the card) and destroys.

    (a) ``FovPipeline.process_rounds(mesh=make_mesh(1))`` over PAR_ROUNDS
    3-channel rounds of bench.py's scene: every field ``torch.equal`` to
    ``process_round`` per round, the mesh run's launches equal to the sum
    of the per-round runs, each of which launches seed_pyramid, lm_fit and
    gather_cubes; bench.py's gate on each round.  (b)
    ``parallel.spatial.sharded_process_round`` on one full-width round
    (spots in channel 0, beads in channel 1, both moved by PAR_SHIFT,
    vignetted; the reference the undrifted beads, corrected): drift within
    0.1 px per
    axis with flag 0, >= 90 % of the planted spots matched within 1 px,
    bench.py's gate on the fitted centres in the round's own frame, lm_fit
    launched; ``lm_fit_single`` on one planted spot of its corrected stack
    launches lm_fit, its centre within 1e-3 px of the plain LM's;
    ``sharded_correct_and_seed`` on channel 0 gives the seed set and count
    of ``get_seeds`` on its corrected stack when both take the plain
    route.  (c) ``FovPrefetcher`` (pinned ring) +
    ``prefetch_to_device`` over PAR_FILES .dax movies of phase 7's layout
    (cold reads): every upload equal to the loader's block; s/file, and the
    pinned and pageable upload GB/s of one block, beside PR 10's reading.
    """
    import shutil
    import tempfile

    import torch.distributed as dist

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.io import (interleave_channels,
                                             load_dax_channels, write_dax)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops.gaussian_fit import (gather_blocks,
                                                           lm_fit_single,
                                                           to_natural)
    from imageanalysis3_tpu_torch.ops.seeding import get_seeds
    from imageanalysis3_tpu_torch.parallel import (FovPrefetcher, make_mesh,
                                                   prefetch_to_device)
    from imageanalysis3_tpu_torch.parallel.spatial import (
        sharded_correct_and_seed, sharded_process_round)
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rec = {"seconds": {}, "launches": {}}
    secs = rec["seconds"]

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("parallel: a process group already exists")
    mesh = make_mesh(1, device_type=device_type, store=dist.HashStore(),
                     rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        if device_type == "cuda" and backend != "nccl":
            raise AssertionError(f"parallel: backend {backend}, not nccl")
        rec["backend"] = backend

        # ---- the scene: bench.py's spots, 3 channels a round -------------
        rng = np.random.default_rng(130)
        truth = syn.sample_spot_params(shape, n_spots, rng,
                                       min_separation=8.0,
                                       height_range=(400.0, 3000.0),
                                       sigma_jitter=0.0)
        base = syn.render_spots(shape, truth["centers"], truth["heights"],
                                background=truth["background"], device=dev)
        prof = torch.as_tensor(syn.illumination_profile(
            shape[1:], falloff=0.35).astype(np.float32), device=dev)
        rounds = torch.stack([torch.stack([
            syn.noisy_uint16(base, seed=1300 + 10 * r + c,
                             illumination=prof) for c in range(3)])
            for r in range(PAR_ROUNDS)])
        ref_raw = torch.stack([syn.noisy_uint16(base, seed=1390 + c,
                                                illumination=prof)
                               for c in range(3)])
        del base
        cfg = ExperimentConfig(
            image_size=shape, correction=CorrectionConfig(),
            seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048),
            fit=FitConfig())
        pipe = FovPipeline(cfg, n_channels=3, drift_channel_index=2,
                           fit_channel_indices=(0, 1, 2),
                           illumination=torch.stack([prof] * 3).cpu().numpy(),
                           image_shape=shape, device=dev)
        ref = pipe.prepare_reference(pipe.correct_reference(ref_raw))
        pipe.process_round(rounds[0], ref)                      # warm

        # ---- (a) the data-parallel rounds --------------------------------
        singles = []
        per_round = []
        for r in range(PAR_ROUNDS):
            reset_kernel_launches()
            singles.append(timed(f"process_round_{r}",
                                 lambda: pipe.process_round(rounds[r], ref)))
            per_round.append(kernel_launches())
            _require_launches(f"parallel: process_round {r}", per_round[-1],
                              PYRAMID_PATH)
            _check_accuracy(f"parallel round {r}", singles[-1],
                            truth["centers"])
        reset_kernel_launches()
        many = timed("process_rounds_mesh",
                     lambda: pipe.process_rounds(rounds, ref, mesh=mesh))
        rec["launches"]["process_rounds_mesh"] = counts = kernel_launches()
        want = {k: sum(c[k] for c in per_round) for k in counts}
        if counts != want:
            raise AssertionError(f"parallel: process_rounds(mesh) launches "
                                 f"{counts}, the rounds' sum {want}")
        for r, one in enumerate(singles):
            for f in one._fields:
                if not torch.equal(getattr(many, f)[r], getattr(one, f)):
                    raise AssertionError(f"parallel: process_rounds(mesh) "
                                         f"round {r} {f} differs from "
                                         f"process_round's")
        rec["launches"]["process_round"] = per_round
        del many, singles, rounds, ref, ref_raw, pipe
        print(f"parallel (a): process_rounds(mesh) over {PAR_ROUNDS} "
              f"rounds x 3 channels {secs['process_rounds_mesh']:.4f} s "
              f"(process_round {[round(secs[f'process_round_{r}'], 4) for r in range(PAR_ROUNDS)]} s), "
              f"equal on every field, launches {counts}  [{smi}]")

        # ---- (b) the spatially sharded round -----------------------------
        d = np.asarray(PAR_SHIFT)
        truth, ims, ref_im, kw = _sharded_scene(torch, dev, shape, n_spots)
        sharded_process_round(ims, ref_im, mesh, **kw)            # warm
        reset_kernel_launches()
        corrected, spots, valid, drift, dflag = timed(
            "sharded_process_round",
            lambda: sharded_process_round(ims, ref_im, mesh, **kw))
        rec["launches"]["sharded_process_round"] = counts = kernel_launches()
        _require_launches("parallel: sharded_process_round", counts,
                          ("lm_fit",), at_least=2)
        drift_np = drift.cpu().numpy()
        d_err = np.abs(drift_np + d)
        if not (d_err <= 0.1).all() or int(dflag) != 0:
            raise AssertionError(f"parallel: sharded drift {drift_np} "
                                 f"(planted {-d}), flag {int(dflag)}")
        got = spots[0][valid[0]][:, 1:4]
        errs, n_m = _matched_errors(torch, got, truth["centers"])
        if n_m < 0.9 * len(truth["centers"]):
            raise AssertionError(f"parallel: sharded round matched {n_m} of "
                                 f"{len(truth['centers'])}")
        # the fitted centres in the round's own frame: the fit's accuracy,
        # apart from the drift's
        own = types.SimpleNamespace(
            spots=spots - torch.cat([torch.zeros(1, device=dev), drift,
                                     torch.zeros(7, device=dev)]),
            valid=valid, drift=drift, drift_flag=dflag)
        med, n_valid = _check_accuracy("parallel sharded round (own frame)",
                                       own, truth["centers"] + d)
        rec["sharded"] = {"drift": drift_np.tolist(),
                          "drift_err": d_err.tolist(), "matched": n_m,
                          "median_err_ref_frame_px": float(np.median(errs)),
                          "median_centroid_err_px": med, "n_valid": n_valid}

        # lm_fit_single: one planted spot, a batch of one through the
        # kernel, against the plain LM on the same block
        seed = torch.as_tensor(np.round(truth["centers"][0] + d),
                               dtype=torch.float32, device=dev)
        px, co, mk = gather_blocks(corrected[0], seed[None], 5)
        reset_kernel_launches()
        one_args = (px[0], co[0], mk[0], seed, 1.0, 0.5, 4.0, 1.5)
        p_card, e_card = lm_fit_single(*one_args)
        rec["launches"]["lm_fit_single"] = counts = kernel_launches()
        _require_launches("parallel: lm_fit_single", counts, ("lm_fit",))
        single_launches = counts["lm_fit"]
        p_cpu, e_cpu = lm_fit_single(*(t.cpu() if torch.is_tensor(t) else t
                                       for t in one_args))
        delta1 = torch.ones(1)
        c_card = to_natural(p_card[None].cpu(), seed[None].cpu(), delta1,
                            0.5, 4.0, e_card[None].cpu())[0, 1:4]
        c_cpu = to_natural(p_cpu[None], seed[None].cpu(), delta1, 0.5, 4.0,
                           e_cpu[None])[0, 1:4]
        single_err = float((c_card - c_cpu).abs().max())
        if not single_err <= 1e-3:
            raise AssertionError(f"parallel: lm_fit_single's centre "
                                 f"{c_card.tolist()} on the card, "
                                 f"{c_cpu.tolist()} plain")
        rec["sharded"]["lm_fit_single_err_px"] = single_err
        del corrected, spots, valid, got, own, px, co, mk

        reset_kernel_launches()
        corr0, seeds = timed("sharded_correct_and_seed",
                             lambda: sharded_correct_and_seed(
                                 ims[0], mesh, illumination=kw[
                                     "illumination"][0],
                                 th_seed=TH_SEED, max_num_seeds=2048))
        plain = timed("get_seeds_plain", lambda: get_seeds(
            corr0, max_num_seeds=2048, th_seed=TH_SEED, pyramid_bg=False,
            slab_x=1000))
        rec["launches"]["seeding_plain"] = counts = kernel_launches()
        if any(counts.values()):
            raise AssertionError(f"parallel: the plain seeding routes "
                                 f"launched kernels: {counts}")

        def coord_set(s):
            return {tuple(c) for c in s.coords[s.valid].cpu().tolist()}

        a, b = coord_set(seeds), coord_set(plain)
        if a != b or int(seeds.count) != int(plain.count):
            raise AssertionError(f"parallel: sharded seeds {len(a)} "
                                 f"(count {int(seeds.count)}) against "
                                 f"get_seeds {len(b)} (count "
                                 f"{int(plain.count)}); {len(a ^ b)} differ")
        rec["sharded"]["seeds"] = len(a)
        del corr0, ims, ref_im
        print(f"parallel (b): sharded_process_round {shape} "
              f"{secs['sharded_process_round']:.4f} s, drift "
              f"{drift_np.round(4).tolist()} (planted {(-d).tolist()}), "
              f"{n_m} of {len(truth['centers'])} matched, median "
              f"{float(np.median(errs)):.5f} px in the reference frame, "
              f"{med:.5f} px in its own; launches "
              f"{rec['launches']['sharded_process_round']}; "
              f"sharded_correct_and_seed {secs['sharded_correct_and_seed']:.4f} "
              f"s, {len(a)} seeds equal to get_seeds' plain route "
              f"({secs['get_seeds_plain']:.4f} s); lm_fit_single launches "
              f"{single_launches}, centre within {single_err:.3g} px of "
              f"the plain LM  [{smi}]")
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("parallel: the group was not destroyed")

    # ---- (c) the prefetcher over .dax movies -----------------------------
    chans, n_z = list(DAX_CHANNELS), shape[0]
    movie_frames = n_z * len(chans) + 2 * DAX_BUFFER
    movie_bytes = movie_frames * int(np.prod(shape[1:])) * 2
    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < (PAR_FILES + 1) * movie_bytes:
        raise AssertionError(f"parallel: {free / 1e9:.2f} GB free under "
                             f"{root}, need "
                             f"{(PAR_FILES + 1) * movie_bytes / 1e9:.2f}")
    tmp = tempfile.mkdtemp(prefix="prefetch_", dir=root)
    try:
        paths = []
        gen = torch.Generator(device=dev)
        gen.manual_seed(134)
        t0 = time.perf_counter()
        for k in range(PAR_FILES):
            movie = torch.randint(0, 65535, (movie_frames,) + shape[1:],
                                  generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.uint16)
            path = os.path.join(tmp, f"Conv_zscan_{k:02d}.dax")
            write_dax(path, movie.cpu().numpy())
            with open(path, "rb+") as fh:
                os.fsync(fh.fileno())
            paths.append(path)
            del movie
        secs["write_movies"] = time.perf_counter() - t0
        for p in paths:
            _cold(p)
        kw = dict(n_z=n_z, buffer_frames=DAX_BUFFER)
        got, item_s = [], []
        pf = FovPrefetcher(paths, chans, depth=2,
                           pin_memory=(dev.type == "cuda"), **kw)
        sync()
        t0 = t_item = time.perf_counter()
        for name, x in prefetch_to_device(pf, device=dev):
            got.append((name, x))
            now = time.perf_counter()
            item_s.append(now - t_item)
            t_item = now
        sync()
        secs["prefetch_total"] = time.perf_counter() - t0
        block_bytes = got[0][1].numel() * 2
        for path, (name, x) in zip(paths, got):
            host = load_dax_channels(path, chans, chans, **kw)
            if name != path or not torch.equal(x.cpu(),
                                               torch.from_numpy(host)):
                raise AssertionError(f"parallel: prefetched {name} differs "
                                     f"from the loader's block")
        if len(got) != PAR_FILES:
            raise AssertionError(f"parallel: {len(got)} of {PAR_FILES} "
                                 f"files prefetched")
        del got, x

        # the upload alone: one block, pinned and pageable, CUDA events
        host = load_dax_channels(paths[0], chans, chans, **kw)
        pinned = timed("pinned_alloc", lambda: torch.empty(
            host.shape, dtype=torch.uint16, pin_memory=(dev.type == "cuda")))
        pinned.numpy()[...] = host
        pageable = torch.from_numpy(host)
        up = {}
        for label, src in (("pinned", pinned), ("pageable", pageable),
                           ("pinned_2", pinned), ("pageable_2", pageable)):
            sync()
            t0 = time.perf_counter()
            y = src.to(dev, non_blocking=True)
            sync()
            up[label] = time.perf_counter() - t0
            del y
        rec["upload_s"] = up
        rec["upload_gb_s"] = {k: block_bytes / v / 1e9 for k, v in up.items()}
        rec["prefetch_s_per_file"] = item_s
        rec["block_bytes"] = block_bytes
        print(f"parallel (c): FovPrefetcher (pinned ring, depth 2) + "
              f"prefetch_to_device over {PAR_FILES} cold .dax files "
              f"({movie_bytes / 1e9:.2f} GB each, {block_bytes / 1e9:.3f} "
              f"GB uploaded each): {secs['prefetch_total']:.4f} s, per file "
              f"{[round(t, 4) for t in item_s]} s, bytes equal to the "
              f"loader's; one block's upload pinned "
              f"{up['pinned']:.4f} / {up['pinned_2']:.4f} s "
              f"({rec['upload_gb_s']['pinned_2']:.2f} GB/s), pageable "
              f"{up['pageable']:.4f} / {up['pageable_2']:.4f} s "
              f"({rec['upload_gb_s']['pageable_2']:.2f} GB/s); PR 10: "
              f"{PR10_UPLOAD}; one pinned block allocated in "
              f"{secs['pinned_alloc']:.4f} s; movies written in "
              f"{secs['write_movies']:.2f} s  [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["total_launches"] = {
        k: sum(c[k] for c in (rec["launches"]["process_rounds_mesh"],
                              rec["launches"]["sharded_process_round"]))
        for k in PYRAMID_PATH}
    print(f"parallel: phase {rec['phase_s']:.2f} s; steps "
          f"{ {k: round(v, 4) for k, v in secs.items()} } s  [{smi}]")
    return rec


#: ranks of the multi-card check (``--only parallel_ranks``)
PAR_RANKS = 4


def _sharded_scene(torch, dev, shape=SHAPE, n_spots=N_SPOTS):
    """Phase 13 (b)'s round: spots (channel 0) and beads (channel 1) moved
    by PAR_SHIFT under the vignette, the corrected undrifted beads as the
    reference; the same tensors from the same seeds on every card."""
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.ops.corrections import correct_channel_stack
    rng = np.random.default_rng(131)
    truth = syn.sample_spot_params(shape, n_spots, rng, min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    beads = syn.sample_spot_params(shape, 500, rng, min_separation=14.0,
                                   height_range=(2000.0, 5000.0),
                                   sigma_jitter=0.0, background=120.0)
    d = np.asarray(PAR_SHIFT)
    prof = torch.as_tensor(syn.illumination_profile(
        shape[1:], falloff=0.35).astype(np.float32), device=dev)
    ims = torch.stack([
        syn.noisy_uint16(syn.render_spots(shape, truth["centers"] + d,
                                          truth["heights"], background=150.0,
                                          device=dev), seed=1331,
                         illumination=prof),
        syn.noisy_uint16(syn.render_spots(shape, beads["centers"] + d,
                                          beads["heights"], background=120.0,
                                          device=dev), seed=1332,
                         illumination=prof)])
    ref_im = correct_channel_stack(
        syn.noisy_uint16(syn.render_spots(shape, beads["centers"],
                                          beads["heights"], background=120.0,
                                          device=dev), seed=1333,
                         illumination=prof)[None],
        illumination_profile=prof[None], do_bleedthrough=False)[0]
    kw = dict(drift_channel_index=1, fit_channel_indices=(0,),
              seed_thresholds=[TH_SEED, TH_SEED],
              illumination=torch.stack([prof, prof]), max_num_seeds=2048)
    return truth, ims, ref_im, kw


def _rank_parallel(rank: int, world: int, port: int, results) -> None:
    """One rank of ``--only parallel_ranks``: the sharded round over
    `world` cards under NCCL, rank 0 also on a one-card mesh."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    try:
        from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                                  reset_kernel_launches)
        from imageanalysis3_tpu_torch.parallel import make_mesh
        from imageanalysis3_tpu_torch.parallel.mesh import gather_cat
        from imageanalysis3_tpu_torch.parallel.spatial import (
            halo_exchange, sharded_process_round)
        timeout = datetime.timedelta(seconds=120)
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", rank)
        store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                              timeout=timeout)
        mesh = make_mesh(device_type="cuda", store=store, rank=rank,
                         world_size=world, timeout=timeout)
        one = make_mesh(1, device_type="cuda", timeout=timeout)
        out = {"backend": dist.get_backend(), "seconds": {}}

        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        x = torch.randn((4, 64 * world, 8), generator=gen, device=dev)
        tiles = gather_cat(halo_exchange(x[:, rank * 64:(rank + 1) * 64]
                                         .contiguous(), 3, mesh), mesh, dim=1)
        pad = np.pad(x.cpu().numpy(), ((0, 0), (3, 3), (0, 0)),
                     mode="symmetric")
        want = np.concatenate([pad[:, r * 64:(r + 1) * 64 + 6]
                               for r in range(world)], axis=1)
        out["halo_equal"] = bool(np.array_equal(tiles.cpu().numpy(), want))

        truth, ims, ref_im, kw = _sharded_scene(torch, dev)

        def run(m, label):
            sharded_process_round(ims, ref_im, m, **kw)          # warm
            torch.cuda.synchronize()
            reset_kernel_launches()
            t0 = time.perf_counter()
            res = sharded_process_round(ims, ref_im, m, **kw)
            torch.cuda.synchronize()
            out["seconds"][label] = time.perf_counter() - t0
            out[f"launches_{label}"] = kernel_launches()
            return res

        dist.barrier()
        res_n = run(mesh, f"sharded_{world}")
        if one is not None:
            res_1 = run(one, "sharded_1")
            # the corrected stacks stay on the card: their comparison goes
            # back, the spot tables and drifts go back whole
            out.update(truth=truth["centers"], shift=np.asarray(PAR_SHIFT),
                       corrected_close=bool(torch.allclose(
                           res_n[0], res_1[0], rtol=2e-5, atol=2e-2)),
                       corrected_max_diff=float(
                           (res_n[0] - res_1[0]).abs().max()),
                       res_n=[t.cpu().numpy() for t in res_n[1:]],
                       res_1=[t.cpu().numpy() for t in res_1[1:]])
        dist.barrier()
        results.put((rank, "ok", out if rank == 0 else {}))
    except BaseException:       # noqa: BLE001 -- reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _parallel_ranks_phase(torch, smi: str) -> dict:
    """``--only parallel_ranks``: the spatially sharded round across
    PAR_RANKS cards (one spawned process each, NCCL over a TCP store on
    localhost) against the same program on one card, rank 0's, in one
    call.  Gates: each rank's halo-extended tile equals the symmetric pad
    exactly; tests/test_spatial.py's one-device tolerances (corrected
    rtol 2e-5 / atol 2e-2, drift atol 5e-3, the same number of spots,
    each within 0.05 px); phase 13 (b)'s drift, match and accuracy gates
    on the sharded result; lm_fit launched on every rank's chunk."""
    import multiprocessing as mp
    import socket

    n = torch.cuda.device_count()
    if n < PAR_RANKS:
        raise AssertionError(f"parallel_ranks: {n} cards, need {PAR_RANKS}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_parallel,
                         args=(r, PAR_RANKS, port, results))
             for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        t0 = time.perf_counter()
        while len(got) < PAR_RANKS:
            left = 600 - (time.perf_counter() - t0)
            rank, status, payload = results.get(timeout=max(1.0, left))
            if status != "ok":
                raise AssertionError(f"parallel_ranks: rank {rank} "
                                     f"failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    out = got[0]
    if out["backend"] != "nccl" or not out["halo_equal"]:
        raise AssertionError(f"parallel_ranks: backend {out['backend']}, "
                             f"halo equal {out['halo_equal']}")
    (sn, vn, dn, fn), (s1, v1, d1, _) = out["res_n"], out["res_1"]
    if not out["corrected_close"]:
        raise AssertionError(f"parallel_ranks: corrected stacks differ by "
                             f"up to {out['corrected_max_diff']}")
    np.testing.assert_allclose(dn, d1, atol=5e-3)
    gn, g1 = sn[0][vn[0]][:, 1:4], s1[0][v1[0]][:, 1:4]
    if len(gn) != len(g1):
        raise AssertionError(f"parallel_ranks: {len(gn)} spots on "
                             f"{PAR_RANKS} cards, {len(g1)} on one")
    far = max(np.linalg.norm(gn - c, axis=1).min() for c in g1)
    if far >= 0.05:
        raise AssertionError(f"parallel_ranks: a spot moved {far} px")
    d_err = np.abs(dn + out["shift"])
    if not (d_err <= 0.1).all() or int(fn) != 0:
        raise AssertionError(f"parallel_ranks: drift {dn}, flag {int(fn)}")
    errs, n_m = _matched_errors(torch, torch.as_tensor(gn),
                                out["truth"])
    if n_m < 0.9 * len(out["truth"]):
        raise AssertionError(f"parallel_ranks: matched {n_m}")
    own = types.SimpleNamespace(
        spots=torch.as_tensor(sn - np.concatenate([[0.0], dn, [0.0] * 7]
                                                  ).astype(np.float32)),
        valid=torch.as_tensor(vn), drift=torch.as_tensor(dn),
        drift_flag=torch.as_tensor(fn))
    med, _ = _check_accuracy(f"parallel_ranks {PAR_RANKS} cards", own,
                             out["truth"] + out["shift"])
    lm = out[f"launches_sharded_{PAR_RANKS}"]["lm_fit"]
    if lm < 2:
        raise AssertionError(f"parallel_ranks: lm_fit launched {lm} times")
    secs = out["seconds"]
    print(f"parallel_ranks: sharded_process_round {SHAPE} over "
          f"{PAR_RANKS} cards (NCCL) {secs[f'sharded_{PAR_RANKS}']:.4f} s "
          f"against one card {secs['sharded_1']:.4f} s; within the "
          f"one-device tolerances (corrected max |d| "
          f"{out['corrected_max_diff']:.4g}, drift max |d| "
          f"{float(np.abs(dn - d1).max()):.4g}, {len(gn)} spots, farthest "
          f"{far:.4g} px); drift {np.round(dn, 4).tolist()}, {n_m} "
          f"matched, own-frame median {med:.5f} px; rank 0's launches "
          f"{out[f'launches_sharded_{PAR_RANKS}']}; halos exact  [{smi}]")
    return {"seconds": secs, "far_px": float(far), "matched": n_m,
            "median_centroid_err_px": med}


#: phase 14's synthetic genome and its probe regions
LIB_GENOME_BP = 10_000_000
LIB_REGIONS = 4
LIB_REGION_BP = 3000


def _library_phase(smi: str) -> dict:
    """Phase 14: ``library/`` on the host, no kernel.  The native seqint is
    built with g++; on a seeded LIB_GENOME_BP-base synthetic sequence its
    ``seq_to_kmer_ints`` (word 17, both strands) and a dense word-12
    ``KmerCountTable`` (33.5 MB) equal the NumPy path's; ``ProbeDesigner``
    designs LIB_REGIONS regions against the word-12 genome map, timed."""
    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch.library import (KmerCountTable, MapSpec,
                                                  ProbeDesigner, seqint)

    rec = {"seconds": {}}
    secs = rec["seconds"]

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    if not timed("build", seqint.native_available):
        raise AssertionError("library: the native seqint did not build")
    rec["library"] = str(_build.native_library_path(
        "seqint", seqint._SRC, seqint.GXX_FLAGS))
    rng = np.random.default_rng(140)
    genome = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, LIB_GENOME_BP)].tobytes()
    fw, rc = timed("kmers17_native",
                   lambda: seqint.seq_to_kmer_ints(genome, 17))
    fw_np, rc_np = timed("kmers17_numpy",
                         lambda: seqint._kmers_numpy(genome, 17, True))
    if not (np.array_equal(fw, fw_np) and np.array_equal(rc, rc_np)):
        raise AssertionError("library: native and NumPy word-17 k-mers "
                             "differ")
    del fw, rc, fw_np, rc_np
    table = KmerCountTable(12, sparse=False)
    timed("table12_native", lambda: table.consume(genome))

    def numpy_table():
        t = np.zeros(4 ** 12, np.uint16)
        fw12, rc12 = seqint._kmers_numpy(genome, 12, True)
        seqint._count_dense_numpy(fw12, t)
        seqint._count_dense_numpy(rc12, t)
        return t

    want = timed("table12_numpy", numpy_table)
    if not np.array_equal(table.table, want):
        raise AssertionError("library: native and NumPy word-12 tables "
                             "differ")
    rec["table12_bytes"] = table.table.nbytes
    rec["table12_nonzero"] = int(np.count_nonzero(table.table))
    del table, want

    gmap = KmerCountTable(12, sparse=False)
    timed("genome_map12", lambda: gmap.consume(genome, count_rc=False))
    text = genome.decode()
    regions = {f"r{k}": text[1_000_000 * (k + 1):
                             1_000_000 * (k + 1) + LIB_REGION_BP]
               for k in range(LIB_REGIONS)}
    designer = ProbeDesigner(
        regions, maps={"genome": MapSpec(gmap, two_stranded=True)},
        pb_len=42, word_size=12, buffer_len=2,
        check_dic={"gc": (0.25, 0.75), "tm": 55.0,
                   ("genome", "self_sequences"): 120})
    cands = timed("designer_reports", designer.compute_reports)
    kept = timed("designer_check", designer.check_probes)
    by_region = designer.kept_by_region()
    rec["designer"] = {"candidates": len(cands), "kept": len(kept),
                       "per_region": {k: len(v) for k, v in
                                      by_region.items()}}
    if min(rec["designer"]["per_region"].values(), default=0) < 10:
        raise AssertionError(f"library: the designer kept "
                             f"{rec['designer']['per_region']}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"library: native seqint built in {secs['build']:.3f} s; "
          f"{LIB_GENOME_BP / 1e6:.0f} Mb: word-17 k-mers native "
          f"{secs['kmers17_native']:.4f} s / NumPy "
          f"{secs['kmers17_numpy']:.4f} s, equal; dense word-12 table "
          f"({rec['table12_bytes'] / 1e6:.1f} MB) native "
          f"{secs['table12_native']:.4f} s / NumPy "
          f"{secs['table12_numpy']:.4f} s, equal; ProbeDesigner "
          f"{LIB_REGIONS} x {LIB_REGION_BP} bp: reports "
          f"{secs['designer_reports']:.4f} s, check "
          f"{secs['designer_check']:.4f} s, kept "
          f"{rec['designer']['per_region']}; phase {rec['phase_s']:.2f} s "
          f"(host only)  [{smi}]")
    return rec


#: phase 15: the legacy facade's scene -- phase 10's grid of nuclei, two
#: chromosome centres a nucleus (LEG_CHROM_DX px either side of its centre
#: in x, jittered by up to 3 px), and in each of the 4 regions one spot
#: within 2 px of every centre, among LEG_CLUTTER spots outside the nuclei
LEG_ROUNDS = 2
LEG_CLUTTER = 1000
LEG_HEIGHTS = (1500.0, 5000.0)
LEG_CLUTTER_HEIGHT = 3000.0
LEG_CHROM_DX = 15.0
LEG_CPU_CELLS = 4
#: the nuclei of every LEG_ROW_STEP-th row of phase 10's grid (32 of 64):
#: the depth cut that keeps the whole script's growth within 75 s
LEG_ROW_STEP = 2


def _ball(rng, n: int, radius: float) -> np.ndarray:
    """(n, 3) points uniform in a ball of `radius`."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius * rng.uniform(0, 1, (n, 1)) ** (1.0 / 3.0)


def _outside_nuclei(rng, n: int, shape, nuclei, margin_px: float = 8.0):
    """(n, 3) points at least `margin_px` (scaled to the smallest
    semi-axis) outside every nucleus and 8 px inside the stack."""
    centres = np.asarray([c for _, c, _ in nuclei])
    semis = np.asarray([s for _, _, s in nuclei], np.float64)
    margin = 1.0 + margin_px / semis.min()
    out = np.zeros((0, 3))
    while len(out) < n:
        p = rng.uniform([8.0] * 3, np.asarray(shape) - 8.0, (4 * n, 3))
        far = (_ellipsoid_value(p[:, None], centres[None], semis[None])
               > margin ** 2).all(axis=1)
        out = np.vstack([out, p[far]])
    return out[:n]


def _legacy_phase(torch, smi: str, dev=None, shape=SHAPE, nuclei=None,
                  n_clutter=LEG_CLUTTER, require=None) -> dict:
    """Phase 15: the legacy facade (``legacy.CellList`` / ``CellData``)
    at a lab's width.  One FOV of LEG_ROUNDS hyb rounds H0R0 and H1R1 in
    phase 8's layout (750 / 647 / 488, 60x2048x2048 uint16, 10 buffer
    frames, ~3.4 GB of movies and a Color_Usage.csv; the free space checked
    first, the folder removed at the end): every other row of phase 10's
    8x8 grid of nuclei (32, cut from 64: LEG_ROW_STEP) saved as the
    segmentation, two chromosome centres in each nucleus,
    each of the 4 regions (u1..u4) planting one spot within 2 px of every
    centre plus LEG_CLUTTER spots outside the nuclei, phase 8's 500 beads
    in 488; H1 moved by a planted drift of at most 2 px per axis.  Steps
    of ``CellList(..., save_images=True)`` on the card, each timed on the
    host clock around ``torch.cuda.synchronize()``: ``_process_fovs``
    (exact classifier), ``_create_cells_fov`` (one cell a nucleus),
    ``_load_segmentation``, ``_load_drift``,
    ``_update_chromosomes_for_cells`` (the planted centres jittered by up
    to 2 px), ``_spot_finding_for_cells`` (fit_window 40; each region
    image read and uploaded once), ``_pick_spots_for_cells("EM")``, the
    distance maps, ``_calculate_population_map("median")``,
    ``_batch_domain_calling``, ``_generate_dependent_maps`` on ternary
    flags, ``_save_cells_to_files`` then ``_load_cells_from_files``.
    Gates, each a hard failure: every region flag 2; the drift within 0.1
    px per axis of the planted one; seed_classify, gather_cubes and lm_fit
    launched in ``_spot_finding_for_cells``; >= 90 % of the (chromosome,
    region) planted spots picked within 1 px at a median error <= 0.05 px
    in H0's frame; LEG_CPU_CELLS cells' candidates equal to the port's CPU
    run of the same cells at the fit tolerances; the population map within
    1e-3 relative of float64 NumPy's ``nanmedian`` over the same screened
    maps; the dependent maps' pools holding exactly the chromosomes
    flagged +1 and -1; the reloaded cells equal.  `dev`, `shape`,
    `nuclei`, `n_clutter` and `require` (the launch check) exist for a CPU
    rehearsal at a small size."""
    import csv
    import shutil
    import tempfile

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.io import (FovStore, interleave_channels,
                                             write_dax)
    from imageanalysis3_tpu_torch.legacy import CellData, CellList
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)

    dev = torch.device("cuda") if dev is None else dev
    require = _require_launches if require is None else require
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    if nuclei is None:
        nuclei = [n for n in _grid_nuclei(shape)
                  if (n[0] - 1) // CELL_GRID % LEG_ROW_STEP == 0]
    chans, n_z = list(DAX_CHANNELS), shape[0]
    fov = "Conv_zscan_00.dax"
    stack_bytes = int(np.prod(shape)) * 2
    movie_bytes = (n_z * len(chans) + 2 * DAX_BUFFER) * stack_bytes // n_z
    need = LEG_ROUNDS * (movie_bytes + 2 * stack_bytes) + stack_bytes
    root = os.path.join(REPO, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 1.5 * need:
        raise AssertionError(f"legacy: {free / 1e9:.2f} GB free under "
                             f"{root}, need {1.5 * need / 1e9:.2f} GB for "
                             f"the movies, stored images and labels")
    rec = {"shape": list(shape), "cells": len(nuclei),
           "movie_bytes": movie_bytes, "seconds": {}, "launches": {}}
    secs = rec["seconds"]

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # ---- the scene ----------------------------------------------------------
    rng = np.random.default_rng(151)
    cell_ids = [cid for cid, _, _ in nuclei]
    chrom = {cid: np.stack([c + [0.0, s * LEG_CHROM_DX, 0.0]
                            + rng.uniform(-3.0, 3.0, 3) for s in (-1, 1)])
             for cid, c, _ in nuclei}
    all_chroms = np.concatenate([chrom[c] for c in cell_ids])
    row_of = {(c, j): 2 * k + j for k, c in enumerate(cell_ids)
              for j in range(2)}
    regions = {}             # rid -> (round, channel index, planted, heights)
    for r in range(LEG_ROUNDS):
        for ci in range(2):
            regions[2 * r + ci + 1] = (
                r, ci, all_chroms + _ball(rng, len(all_chroms), 2.0),
                rng.uniform(*LEG_HEIGHTS, len(all_chroms)))
    clutter = {rid: _outside_nuclei(rng, n_clutter, shape, nuclei)
               for rid in regions}
    beads = syn.sample_spot_params(shape, 500, rng, min_separation=14.0,
                                   height_range=(2000.0, 5000.0),
                                   sigma_jitter=0.0, background=120.0)
    drifts = np.vstack([np.zeros(3), rng.uniform(-2.0, 2.0,
                                                 (LEG_ROUNDS - 1, 3))])
    rec["planted_drifts"] = drifts.tolist()

    tmp = tempfile.mkdtemp(prefix="legacy_", dir=root)
    try:
        data = os.path.join(tmp, "data")
        secs["write"] = 0.0
        for r in range(LEG_ROUNDS):
            t0 = time.perf_counter()
            chs = []
            for ci in range(2):
                _, _, planted, heights = regions[2 * r + ci + 1]
                centers = np.vstack([planted, clutter[2 * r + ci + 1]])
                h = np.concatenate([heights, np.full(
                    n_clutter, LEG_CLUTTER_HEIGHT)])
                im = syn.render_spots(shape, centers + drifts[r], h,
                                      background=150.0, device=dev)
                chs.append(syn.noisy_uint16(im, seed=150 + 10 * r + ci))
                del im
            im = syn.render_spots(shape, beads["centers"] + drifts[r],
                                  beads["heights"], background=120.0,
                                  device=dev)
            chs.append(syn.noisy_uint16(im, seed=152 + 10 * r))
            del im
            movie = interleave_channels([c.cpu().numpy() for c in chs],
                                        buffer_frames=DAX_BUFFER)
            del chs
            secs[f"render_H{r}"] = time.perf_counter() - t0
            folder = os.path.join(data, f"H{r}R{r}")
            os.makedirs(folder)
            path = os.path.join(folder, fov)

            def write():
                write_dax(path, movie)
                with open(path, "rb+") as fh:
                    os.fsync(fh.fileno())
            timed("write_one", write)
            secs["write"] += secs.pop("write_one")
            del movie
        with open(os.path.join(data, "Color_Usage.csv"), "w",
                  newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["Hyb"] + chans)
            for r in range(LEG_ROUNDS):
                w.writerow([f"H{r}R{r}", f"u{2 * r + 1}", f"u{2 * r + 2}",
                            "beads"])
        print(f"legacy: {LEG_ROUNDS} movies of {movie_bytes / 1e9:.3f} GB "
              f"written in {secs['write']:.3f} s; {len(nuclei)} nuclei, "
              f"{len(all_chroms)} chromosomes x {len(regions)} regions; "
              f"planted drifts {drifts.round(4).tolist()}  [{smi}]")

        cfg = ExperimentConfig(
            image_size=shape, corr_channels=("750", "647"),
            correction=CorrectionConfig(illumination=False),
            seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048,
                            pyramid_bg=False),
            fit=FitConfig())

        # ---- 1. _process_fovs ---------------------------------------------------
        cl = CellList(data, os.path.join(tmp, "save"), cfg=cfg,
                      save_images=True, device=dev)
        reset_kernel_launches()
        counts = timed("process_fovs", cl._process_fovs)
        rec["launches"]["process_fovs"] = kernel_launches()
        path = cl.driver.store_path(fov)
        with FovStore(path, "r") as store:
            ids = [int(i) for i in store.ids("unique")]
            flags = store.flags("unique").tolist()
            stored = store.drifts("unique")
            rec["store_backend"] = store.backend
        drift_of = dict(zip(ids, stored))
        derr = {rid: np.abs(drift_of[rid] + drifts[regions[rid][0]])
                for rid in regions}
        rec["flags"] = flags
        rec["drift_err"] = {rid: e.round(4).tolist()
                            for rid, e in derr.items()}
        if (counts != {fov: {"unique": len(regions)}}
                or any(f != 2 for f in flags)
                or max(e.max() for e in derr.values()) > 0.1):
            raise AssertionError(f"legacy: _process_fovs processed {counts},"
                                 f" flags {flags}, drift errors "
                                 f"{rec['drift_err']}")

        # ---- 2-3. cells, segmentation, drift ------------------------------------
        labels = _nuclei_labels(torch, shape, dev, nuclei)
        lab_host = labels.to(torch.int16).cpu().numpy()
        del labels
        with FovStore(path) as store:
            timed("save_segmentation",
                  lambda: store.save_segmentation(lab_host))
        del lab_host
        cells = timed("create_cells_fov", lambda: cl._create_cells_fov(fov))
        if [c.cell_id for c in cells] != sorted(cell_ids):
            raise AssertionError(f"legacy: _create_cells_fov made cells "
                                 f"{[c.cell_id for c in cells]}")
        timed("load_segmentation", cl._load_segmentation)
        timed("load_drift", cl._load_drift)
        if not all(c._check_drift() for c in cells):
            raise AssertionError("legacy: a cell's drift table is missing "
                                 "or flagged")
        for c in cells:            # the full-FOV masks are not needed again
            c.segmentation_label = None

        # ---- 4-5. chromosomes and the multi-fit ---------------------------------
        picks = [[chrom[c.cell_id][j] + _ball(rng, 1, 2.0)[0]
                  for j in range(2)] for c in cells]
        timed("update_chromosomes",
              lambda: cl._update_chromosomes_for_cells(picks))
        reset_kernel_launches()
        timed("spot_finding", lambda: cl._spot_finding_for_cells(
            "unique", fit_window=40))
        rec["launches"]["spot_finding"] = found = kernel_launches()
        require("legacy: _spot_finding_for_cells", found, LEGACY_PATH)
        rec["candidates"] = int(sum(len(v) for c in cells
                                    for v in c.cand_spots.values()))
        rec["driver_stages"] = cl.driver.timings.summary()
        print(f"legacy: _process_fovs {secs['process_fovs']:.3f} s "
              f"({counts}, drift errors {rec['drift_err']}; stages "
              f"{ {k: round(v, 4) for k, v in rec['driver_stages'].items()} }"
              f" s); "
              f"_spot_finding_for_cells {secs['spot_finding']:.3f} s for "
              f"{len(cells)} cells x 2 chromosomes x {len(regions)} regions "
              f"({rec['candidates']} candidates), launches "
              f"{ {k: found[k] for k in LEGACY_PATH} }  [{smi}]")

        # the port's CPU run of LEG_CPU_CELLS cells on the same images
        sel = np.linspace(0, len(cells) - 1, LEG_CPU_CELLS).astype(int)
        t0 = time.perf_counter()
        with FovStore(path, "r") as store:      # float32 once, as the card's
            ims = {rid: torch.from_numpy(np.array(store.load_image(
                "unique", rid))).to(torch.float32) for rid in ids}
        for i in sel:
            want = CellData({}, chrom_coords=cells[i].chrom_coords,
                            device="cpu")._multi_fitting_for_chromosome(
                                ims, fit_window=40)
            for rid, w in want.items():
                g = cells[i].cand_spots[rid]
                ok = (g.shape == w.shape and np.allclose(
                    g[:, 1:4], w[:, 1:4], rtol=0, atol=1e-3)
                    and np.allclose(g[:, 0], w[:, 0], rtol=1e-2)
                    and np.allclose(g[:, 5:8], w[:, 5:8], rtol=0,
                                    atol=1e-3))
                if not ok:
                    raise AssertionError(
                        f"legacy: cell {cells[i].cell_id} region u{rid}: "
                        f"card {g.tolist()} vs CPU {w.tolist()}")
        secs["cpu_cells"] = time.perf_counter() - t0
        del ims

        # ---- 6. EM picks ------------------------------------------------------------
        traces = timed("pick_spots_em",
                       lambda: cl._pick_spots_for_cells("EM"))
        errs, total = [], 0
        for cell, tr in zip(cells, traces):
            rids = sorted(cell.cand_spots)
            for j, trace in enumerate(tr):
                for k, rid in enumerate(rids):
                    total += 1
                    p = trace[k, 1:4].astype(np.float64) + drift_of[rid]
                    e = np.linalg.norm(
                        p - regions[rid][2][row_of[(cell.cell_id, j)]])
                    if e < 1.0:
                        errs.append(e)
        rec["picked"] = {"matched": len(errs), "of": total,
                         "median_err_px": float(np.median(errs))
                         if errs else float("nan")}
        if (len(errs) < 0.9 * total
                or not rec["picked"]["median_err_px"] <= 0.05):
            raise AssertionError(f"legacy: EM picks {rec['picked']}")

        # ---- 7-10. maps, domains, flags ---------------------------------------------
        maps = timed("distance_maps",
                     lambda: [c._generate_distance_map() for c in cells])
        pop, n_used = timed("population_map",
                            lambda: cl._calculate_population_map("median"))

        def kept(ms):
            return [m.astype(np.float64) for m in ms if np.sum(
                np.isnan(m).sum(0) >= len(m) - 1) / len(m) <= 0.2]

        flat = [m for ms in maps for m in ms]
        ref = np.nanmedian(np.stack(kept(flat)), axis=0)
        rel = float(np.nanmax(np.abs(pop - ref) / np.maximum(
            np.abs(ref), 1e-12)))
        rec["population"] = {"n_used": n_used, "of": len(flat),
                             "max_rel_err": rel}
        if n_used != len(kept(flat)) or not rel <= 1e-3 or not np.array_equal(
                np.isnan(pop), np.isnan(ref)):
            raise AssertionError(f"legacy: population map {rec['population']}")
        domains = timed("batch_domain_calling", cl._batch_domain_calling)
        n_reg = len(regions)
        bad = [d for ds in domains for d in ds
               if not (len(d) and d[0] == 0 and np.all(np.diff(d) > 0)
                       and d[-1] < n_reg)]
        rec["domain_starts"] = sorted({tuple(int(v) for v in d)
                                       for ds in domains for d in ds})
        if bad or len(domains) != len(cells):
            raise AssertionError(f"legacy: domain starts {bad[:4]}")
        ternary = rng.integers(-1, 2, (len(cells), 2))
        dep = timed("dependent_maps", lambda: cl._generate_dependent_maps(
            [list(f) for f in ternary]))
        for key, sign in (("on", 1), ("off", -1)):
            pool = kept([m for ms, f in zip(maps, ternary)
                         for m, v in zip(ms, f) if v == sign])
            got = dep[key]
            if (got is None) != (not pool) or (pool and (
                    got[1] != len(pool) or not np.array_equal(
                        got[0], np.nanmedian(np.stack(pool), axis=0),
                        equal_nan=True))):
                raise AssertionError(f"legacy: dependent map '{key}' holds "
                                     f"{None if got is None else got[1]} "
                                     f"chromosomes, {len(pool)} flagged")
        rec["dependent"] = {k: None if v is None else v[1]
                            for k, v in dep.items()}

        # ---- 11. checkpoints ---------------------------------------------------------
        folder = os.path.join(tmp, "cells")
        before = [(c.cand_spots, c.chrom_coords, c.picked_traces,
                   c.distance_maps) for c in cells]
        timed("save_cells", lambda: cl._save_cells_to_files(folder))
        loaded = timed("load_cells", lambda: cl._load_cells_from_files(folder))
        for (cand, cc, tr, dm), c in zip(before, loaded):
            same = (list(c.cand_spots) == list(cand)
                    and all(np.array_equal(c.cand_spots[k], v)
                            for k, v in cand.items())
                    and np.array_equal(np.asarray(c.chrom_coords),
                                       np.asarray(cc))
                    and all(np.array_equal(a, b, equal_nan=True)
                            for a, b in zip(c.picked_traces, tr))
                    and all(np.array_equal(a, b, equal_nan=True)
                            for a, b in zip(c.distance_maps, dm)))
            if not same:
                raise AssertionError("legacy: a reloaded cell differs")
        if len(loaded) != len(before):
            raise AssertionError(f"legacy: {len(loaded)} cells reloaded of "
                                 f"{len(before)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    rec["total_launches"] = {k: found[k] for k in LEGACY_PATH}
    rec["per_cell_seconds"] = {k: secs[k] / len(nuclei) for k in (
        "load_segmentation", "spot_finding", "pick_spots_em",
        "batch_domain_calling") if k in secs}
    print(f"legacy: phase {rec['phase_seconds']:.1f} s; picks "
          f"{rec['picked']}; population {rec['population']}; dependent "
          f"pools {rec['dependent']}; domain starts {rec['domain_starts']}; "
          f"steps { {k: round(v, 4) for k, v in secs.items()} } s; per cell "
          f"{ {k: round(v, 5) for k, v in rec['per_cell_seconds'].items()} }"
          f" s  [{smi}]")
    return rec


#: phase 16: SpotBrowser's zoomed view of the bench stack, (x0, y0) and its
#: xy extent
FIG_VIEW_AT = (896, 1152)
FIG_VIEW = 256
FIG_CELL_BITS = 60                  # readout bits in the cell-count matrix


def _png_sizes(paths) -> dict:
    """File name -> bytes; raises unless every file holds > 1000 bytes."""
    sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
    small = {k: v for k, v in sizes.items() if v <= 1000}
    if small:
        raise AssertionError(f"figures: PNGs of <= 1000 bytes: {small}")
    return sizes


def _figures_phase(torch, smi: str, dev=None, shape=SHAPE,
                   n_spots=N_SPOTS, view_at=FIG_VIEW_AT, nuclei=None,
                   n_chroms=AN_CHROMS, require=None) -> dict:
    """Phase 16: ``figures/`` under Agg, where matplotlib imports (the
    probe catches ``ModuleNotFoundError`` for matplotlib and nothing else;
    without it the phase says why and returns).  ``SpotBrowser`` over slice
    1's corrected bench stack (60x2048x2048 f32 on the card), zoomed to a
    60x256x256 view: ``seed_view`` launches seed_classify once, its seeds
    equal to the port's CPU ``seed_view`` on the same view except seeds
    within hazard 6's qdiff tolerance (atol 0.05 + rtol 1e-4) of the
    dynamic threshold, counted; ``fit_view`` launches gather_cubes and
    lm_fit, >= 90 % of the view's planted spots (3 px inside it) found
    within 1 px at a median <= 0.05 px.  ``BoundaryMarker`` on the median
    map of phase 11's 2048-chromosome population (300 regions): the
    planted domain starts marked, its ``.npz`` reloaded equal.  Then each
    ``plots`` and ``render3d`` function draws once at a lab's size (the
    300x300 map, the bench stack and its fits, phase 10's label volume, a
    genome-wide cell of ~1000 loci, the population's chromosomes) and
    writes a PNG of > 1000 bytes.  Every step is timed on the host clock
    around ``torch.cuda.synchronize()``.  `dev`, `shape`, `n_spots`,
    `view_at`, `nuclei`, `n_chroms` and `require` (the launch check) exist
    for a CPU rehearsal at a small size."""
    import shutil
    import tempfile

    rec = {"seconds": {}, "launches": {}}
    try:
        import matplotlib
    except ModuleNotFoundError as err:
        if err.name != "matplotlib":
            raise
        rec["not_run"] = (f"figures: not run: matplotlib is not installed "
                          f"on this machine ({err})")
        print(rec["not_run"])
        return rec
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from imageanalysis3_tpu_torch import figures as FG
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.analysis import distmap
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.decode.merfish import SpotGroups
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops.seeding import get_seeds
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    dev = torch.device("cuda") if dev is None else dev
    require = _require_launches if require is None else require
    on_card = dev.type == "cuda"
    secs = rec["seconds"]
    rec["matplotlib"] = matplotlib.__version__
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # ---- slice 1's corrected bench stack ----------------------------------------
    rng = np.random.default_rng(0)
    truth = syn.sample_spot_params(shape, n_spots, rng, min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    base = syn.render_spots(shape, truth["centers"], truth["heights"],
                            background=truth["background"], device=dev)
    x = torch.linspace(-1, 1, shape[1], device=dev)[:, None]
    y = torch.linspace(-1, 1, shape[2], device=dev)[None, :]
    prof = (1.0 - 0.35 * (x * x + y * y) / 2.0).clamp(0.2, 1.0)
    raw = syn.noisy_uint16(base, seed=1, illumination=prof)
    del base
    pipe = FovPipeline(ExperimentConfig(
        image_size=shape, correction=CorrectionConfig(),
        seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048),
        fit=FitConfig()), n_channels=1, drift_channel_index=0,
        fit_channel_indices=(0,), illumination=prof[None].cpu().numpy(),
        image_shape=shape, device=dev)
    corrected = pipe.correct_one(raw, 0)
    del raw, pipe

    tmp = tempfile.mkdtemp(prefix="figures_", dir=os.path.join(REPO,
                                                              "build"))
    pngs = []

    def png(name):
        pngs.append(os.path.join(tmp, name + ".png"))
        return pngs[-1]

    try:
        # ---- SpotBrowser -----------------------------------------------------------
        x0, y0 = view_at
        kw = dict(seed_kwargs=dict(th_seed=TH_SEED))

        def zoomed(device, ims):
            b = FG.SpotBrowser(ims, device=device, **kw)
            b.ax_xy.set_xlim(y0, y0 + FIG_VIEW)
            b.ax_xy.set_ylim(x0 + FIG_VIEW, x0)
            b.set_image(0)
            return b

        b = timed("spot_browser", lambda: zoomed(dev, [corrected]))
        view = b.view_limits()
        if view != (0, shape[0], x0, x0 + FIG_VIEW, y0, y0 + FIG_VIEW):
            raise AssertionError(f"figures: the zoomed view is {view}")
        reset_kernel_launches()
        seeds = timed("seed_view", b.seed_view)
        rec["launches"]["seed_view"] = counted = kernel_launches()
        require("figures: seed_view", counted, ("seed_classify",))
        if on_card and counted["seed_classify"] != 1:
            raise AssertionError(f"figures: seed_view launched "
                                 f"seed_classify {counted['seed_classify']}"
                                 f" times")
        cpu_b = timed("spot_browser_cpu", lambda: zoomed("cpu", b.ims))
        cpu_seeds = timed("seed_view_cpu", cpu_b.seed_view)
        got = {tuple(s) for s in seeds.astype(int).tolist()}
        want = {tuple(s) for s in cpu_seeds.astype(int).tolist()}
        sub = corrected[:, x0:x0 + FIG_VIEW, y0:y0 + FIG_VIEW].contiguous()
        allowed = 0
        for d_sub, extra in ((sub, got - want), (sub.cpu(), want - got)):
            if not extra:
                continue
            s = get_seeds(d_sub, th_seed=TH_SEED)
            th = float(s.threshold)
            h = {tuple((c + [0, x0, y0]).tolist()): float(v) for c, v, ok in
                 zip(s.coords.cpu().numpy(), s.heights.cpu().numpy(),
                     s.valid.cpu().numpy()) if ok}
            for c in extra:
                if abs(h[c] - th) > 0.05 + 1e-4 * abs(th):
                    raise AssertionError(
                        f"figures: seed {c} (height {h[c]}, threshold "
                        f"{th}) found on one device only")
                allowed += 1
        rec["seeds"] = {"card": len(got), "cpu": len(want),
                        "differ_within_hazard_6": allowed}
        reset_kernel_launches()
        rows = timed("fit_view", b.fit_view)
        rec["launches"]["fit_view"] = fitted = kernel_launches()
        require("figures: fit_view", fitted, ("gather_cubes", "lm_fit"))
        t = truth["centers"]
        inside = t[(t[:, 1] >= x0 + 3) & (t[:, 1] < x0 + FIG_VIEW - 3)
                   & (t[:, 2] >= y0 + 3) & (t[:, 2] < y0 + FIG_VIEW - 3)]
        errs, n_m = _matched_errors(
            torch, torch.as_tensor(rows[:, 1:4], device=dev), inside)
        rec["fit"] = {"rows": len(rows), "planted": len(inside),
                      "matched": n_m, "median_err_px":
                      float(np.median(errs)) if n_m else float("nan")}
        if n_m < 0.9 * len(inside) or not rec["fit"]["median_err_px"] <= 0.05:
            raise AssertionError(f"figures: fit_view {rec['fit']}")
        rec["total_launches"] = {k: counted[k] + fitted[k]
                                 for k in LEGACY_PATH}
        print(f"figures: matplotlib {rec['matplotlib']}; SpotBrowser "
              f"{secs['spot_browser']:.3f} s, view {view}; seed_view "
              f"{secs['seed_view']:.4f} s ({rec['seeds']}), fit_view "
              f"{secs['fit_view']:.4f} s ({rec['fit']}); launches "
              f"{rec['total_launches']}  [{smi}]")
        plt.close("all")

        # ---- BoundaryMarker on a 300-region population map ------------------------
        prng = np.random.default_rng(43)
        sizes = _domain_sizes(prng)
        z, starts, comp, _, _, _ = _domain_population(prng, n_chroms, sizes)
        zt = torch.as_tensor(z, device=dev)
        med = timed("median_map", lambda: distmap.median_distance_map(
            zt).cpu().numpy())
        npz = os.path.join(tmp, "bounds.npz")
        m = FG.BoundaryMarker([med], names=["population"], save_file=npz)
        m.fig.canvas.draw()
        for s in starts[1:]:
            m.add_boundary(float(s) - 0.3, float(s) + 0.3)
        m.autoscale()
        back = FG.BoundaryMarker([med], save_file=npz)
        if (not np.array_equal(m.domain_starts(), starts)
                or not np.array_equal(back.positions, m.positions)):
            raise AssertionError(f"figures: BoundaryMarker starts "
                                 f"{m.domain_starts()} vs {starts}")
        m.fig.savefig(png("boundary_marker"))
        plt.close("all")

        # ---- every plot and render at a lab's size ----------------------------------
        labels = _nuclei_labels(torch, shape, dev, nuclei)
        grng = np.random.default_rng(160)
        chr_zxys = [np.cumsum(grng.normal(0, 0.3, (GENOME_LOCI // 23, 3)),
                              axis=0) for _ in range(23)]
        edges = np.concatenate([[0], np.cumsum([len(c) for c in chr_zxys])])
        groups = SpotGroups(
            spot_idx=torch.zeros((4000, 4), dtype=torch.int64, device=dev),
            region=torch.as_tensor(grng.integers(1, 301, 4000),
                                   dtype=torch.int32, device=dev),
            n_spots=torch.as_tensor(grng.integers(2, 5, 4000),
                                    dtype=torch.int32, device=dev),
            ok=torch.as_tensor(grng.uniform(size=4000) < 0.9, device=dev),
            spot_usage=torch.zeros(16000, dtype=torch.int32, device=dev))
        starts_per_chrom = [
            np.unique(np.clip(starts + grng.integers(-1, 2, len(starts)),
                              0, AN_REGIONS - 1)) for _ in range(n_chroms)]
        one = z[0]
        draws = {
            "plot_distance_map": lambda: FG.plot_distance_map(
                med, save_path=png("distance_map")),
            "plot_boundaries": lambda: FG.plot_boundaries(
                med, starts, save_path=png("boundaries")),
            "plot_projection": lambda: FG.plot_projection(
                corrected, save_path=png("projection")),
            "plot_spot_overlay": lambda: FG.plot_spot_overlay(
                corrected, rows, axis=1, save_path=png("spot_overlay")),
            "plot_decode_stats": lambda: FG.plot_decode_stats(
                groups, save_path=png("decode_stats")),
            "plot_segmentation_labels": lambda: FG.plot_segmentation_labels(
                labels, z=shape[0] // 2, spots=rows,
                save_path=png("segmentation_labels")),
            "plot_cell_spot_counts": lambda: FG.plot_cell_spot_counts(
                grng.integers(0, 80, (CELL_GRID ** 2, FIG_CELL_BITS)),
                save_path=png("cell_spot_counts")),
            "plot_boundary_probability": lambda:
                FG.plot_boundary_probability(
                    np.arange(AN_REGIONS), starts_per_chrom,
                    save_path=png("boundary_probability")),
            "plot_genome_wide_distance_map": lambda:
                FG.plot_genome_wide_distance_map(
                    chr_zxys, GENOME_CHRS, edges,
                    save_path=png("genome_wide_distance_map")),
            "plot_spot_crops": lambda: FG.plot_spot_crops(
                corrected, rows[:64], radius=10,
                save_path=png("spot_crops")),
            "chromosome_structure_3d_rendering": lambda:
                FG.chromosome_structure_3d_rendering(
                    one, image_radius=2000.0,
                    save_path=png("structure_3d")),
            "visualize_chromosome_3d_cloud": lambda:
                FG.visualize_chromosome_3d_cloud(
                    one, {"A": np.flatnonzero(comp == 0),
                          "B": np.flatnonzero(comp == 1)},
                    save_path=png("cloud_3d")),
        }
        for name, fn in draws.items():
            timed(name, fn)
            plt.close("all")
        del labels
        normed = timed("normalize_center_spots", lambda: [
            FG.normalize_center_spots(c) for c in z])
        dens = timed("spots_to_density", lambda: FG.spots_to_density(
            normed[0]))
        capped = timed("remove_cap", lambda: FG.remove_cap(sub))
        crops = timed("extract_spot_crops", lambda: FG.extract_spot_crops(
            corrected, rows, radius=10))
        colors = timed("colormaps", lambda: [
            FG.normalize_color(med), FG.transparent_cmap("viridis"),
            FG.black_gradient((1.0, 0.5, 0.0)),
            FG.transparent_gradient((0.2, 0.4, 0.9)),
            *(getattr(FG, n) for n in ("myReds", "myBlues", "myGreens",
                                       "myReds_r", "myBlues_r",
                                       "myGreens_r"))])
        if (len(normed) != n_chroms or not np.isfinite(dens).all()
                or capped.shape != tuple(sub.shape)
                or crops.shape != (len(rows), 21, 21, 21)
                or not np.nanmax(colors[0]) == 1.0):
            raise AssertionError("figures: a helper returned the wrong "
                                 "shape or range")
        rec["png_bytes"] = _png_sizes(pngs)
    finally:
        plt.close("all")
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_seconds"] = time.perf_counter() - t_phase
    print(f"figures: phase {rec['phase_seconds']:.1f} s; {len(pngs)} PNGs "
          f"{rec['png_bytes']}; steps "
          f"{ {k: round(v, 4) for k, v in secs.items()} } s  [{smi}]")
    return rec


def _profile_round(torch, pipe, raw, ref_im, smi: str) -> dict:
    """One main-path round under torch.profiler: device time by kernel and
    the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.process_round(raw[None], ref_im)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only: the aten ops that launched them carry
        # the same time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: round wall {wall_ms:.2f} ms (profiled), device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)  [{smi}]")
    for ms, count, key in rows[:20]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"ms": ms, "count": c, "name": k} for ms, c, k in rows]}


#: rounds of each path the tracing phase counts, and spans it times
TRACE_ROUNDS = 3
TRACE_SPANS = 2000
#: the only places a round may wait on the card
WAIT_SITES = {"refit_check", "drift_flag", "upload"}


def _tracing_phase(torch, smi: str, dev, shape=DUAL_SHAPE,
                   n_spots=N_SPOTS) -> dict:
    """Phase 17: the port's span record (``tracing``) on the card.

    (a) The clock: spans around ``add_`` launches under torch.profiler hold
    each aten op's interval on the profiler's clock (``trace_start_ns()``
    plus ``time_range`` in us).  (b) On TRACE_ROUNDS 3-channel rounds of
    bench.py's spots at `shape` (channel 2 the drift channel, 0 and 1
    fitted), through ``process_round`` and through ``process_round_raw``
    from pinned raw windows: the synchronising calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports inside the rounds,
    recording off and on, equal each other and the rounds' own count, none
    falls outside a sync span, and every sync span is one of WAIT_SITES
    (the host reads a value that decides what it launches next, or
    uploads); the rounds, after a warm-up round of the same shapes, build
    no device constant (``const_builds`` 0); every output ``torch.equal``
    with recording on and off; each round's correct, drift, input and fit
    event intervals against its round's.  (c) One profiled round with the record
    on and one with it held off (the same round): the same device ops, by
    name and count.  (d) The cost: a span and a sync span with recording
    off, and on (two CUDA events), over TRACE_SPANS; rounds/s with
    recording off and on, in turns; the recorded rounds' host time, the
    host's own, syncs and event intervals, without the profiler and under
    it.
    """
    import collections
    import contextlib
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch import tracing
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    rec = {"card": smi}
    t_phase = time.perf_counter()

    # ---- (a) the clock ---------------------------------------------------
    x = torch.ones(1 << 20, device=dev)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with tracing.span("add"):
                x.add_(1)
        torch.cuda.synchronize()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e for e in prof.events() if e.name == "aten::add_"]
    spans = tracing.record().loose
    gaps = [((t0 + e.time_range.start * 1000 - s.start_ns) / 1e3,
             (s.end_ns - t0 - e.time_range.end * 1000) / 1e3)
            for e, s in zip(ops, spans)]
    if len(ops) != 20 or len(spans) != 20 or min(min(g) for g in gaps) < 0:
        raise AssertionError(f"tracing: aten::add_ outside its span on the "
                             f"profiler's clock: {len(ops)} ops, "
                             f"{len(spans)} spans, gaps (us) {gaps}")
    rec["clock_gap_us"] = [min(g[0] for g in gaps), max(g[0] for g in gaps),
                           min(g[1] for g in gaps), max(g[1] for g in gaps)]
    print(f"tracing: clock, 20 aten::add_ inside their spans, "
          f"{rec['clock_gap_us'][0]:.2f}-{rec['clock_gap_us'][1]:.2f} us in "
          f"from the start, {rec['clock_gap_us'][2]:.2f}-"
          f"{rec['clock_gap_us'][3]:.2f} us from the end  [{smi}]")

    # ---- the scene -------------------------------------------------------
    rng = np.random.default_rng(170)
    truth = syn.sample_spot_params(shape, n_spots, rng, min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    base = syn.render_spots(shape, truth["centers"], truth["heights"],
                            background=truth["background"], device=dev)
    illum = torch.as_tensor(syn.illumination_profile(
        shape[1:], falloff=0.35).astype(np.float32), device=dev)
    stacks = [torch.stack([syn.noisy_uint16(base, seed=1700 + 10 * r + c,
                                            illumination=illum)
                           for c in range(3)])
              for r in range(TRACE_ROUNDS + 1)]
    del base
    # raw windows: frame 3z + c holds channel c, in pinned host memory
    raws = [s.permute(1, 0, 2, 3).reshape(-1, *shape[1:]).cpu().pin_memory()
            for s in stacks[1:]]
    pipe = FovPipeline(
        ExperimentConfig(image_size=shape, correction=CorrectionConfig(),
                         seed=SeedConfig(th_seed=TH_SEED,
                                         max_num_seeds=2048),
                         fit=FitConfig()),
        n_channels=3, drift_channel_index=2, fit_channel_indices=(0, 1),
        illumination=illum[None].expand(3, -1, -1).cpu().numpy(),
        image_shape=shape, device=dev)
    ref = pipe.prepare_reference(pipe.correct_reference(stacks[0]))
    paths = {
        "process_round": lambda r: pipe.process_round(stacks[1 + r], ref),
        "process_round_raw": lambda r: pipe.process_round_raw(
            raws[r], ref, (0, 1, 2), 3)}
    for run in paths.values():
        run(0)
    torch.cuda.synchronize()

    def counted(run):
        """The rounds with every synchronising call counted (warnings
        whose stack passes through the port)."""
        sites = collections.Counter()

        def hook(message, *a, **k):
            if "synchroniz" not in str(message):
                return
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "imageanalysis3_tpu_torch" in f.filename
                      and not f.filename.endswith("tracing.py")]
            if frames:
                f = frames[-1]
                sites[f"{os.path.basename(f.filename)}:{f.lineno}"] += 1

        outs = []
        old = warnings.showwarning
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            try:
                for r in range(TRACE_ROUNDS):
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        outs.append(run(r))
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
            finally:
                warnings.showwarning = old
        torch.cuda.synchronize()
        return outs, sites

    # ---- (b) syncs counted, outputs, event intervals ----------------------
    rec["paths"] = {}
    for name, run in paths.items():
        off, off_sites = counted(run)
        tracing.clear()
        with tracing.recording():
            on, on_sites = counted(run)
        rounds = tracing.record().rounds
        syncs = sum(spans[0].attrs["syncs"] for spans in rounds)
        unmarked = sum(spans[0].attrs["unmarked_syncs"] for spans in rounds)
        builds = [spans[0].attrs["const_builds"] for spans in rounds]
        by_site = collections.Counter(
            s.attrs["site"] for spans in rounds for s in spans
            if s.name == "sync")
        n_off, n_on = sum(off_sites.values()), sum(on_sites.values())
        same = all(torch.equal(a, b) for ro, rn in zip(off, on)
                   for a, b in zip(ro, rn))
        ratio = []      # (none on the CPU: no CUDA events)
        for spans in rounds:
            if spans[0].device_ms is not None:
                parts = sum(s.device_ms for s in spans if s.name in (
                    "correct", "drift", "input", "fit"))
                ratio.append(parts / spans[0].device_ms)
        p = rec["paths"][name] = {
            "debug_syncs_off": n_off, "debug_syncs_on": n_on,
            "round_syncs": syncs, "unmarked_syncs": unmarked,
            "const_builds": builds,
            "per_round": syncs / TRACE_ROUNDS, "sync_spans": dict(by_site),
            "debug_sites": dict(on_sites), "outputs_equal": same,
            "parts_over_round": ratio,
            "round_device_ms": [s[0].device_ms for s in rounds],
            "round_host_ms": [s[0].host_ms for s in rounds]}
        print(f"tracing: {name}, {TRACE_ROUNDS} rounds: {n_off} synchronising "
              f"calls off, {n_on} on, the rounds count {syncs} "
              f"({p['per_round']:.1f} a round), {unmarked} outside a sync "
              f"span; const_builds {builds}; outputs equal {same}; stages "
              f"over the round's event interval "
              f"{[round(v, 4) for v in ratio]}; sync spans by site "
              f"{dict(by_site)}  [{smi}]")
        if not (n_off == n_on == syncs and unmarked == 0 and same
                and set(by_site) <= WAIT_SITES and not any(builds)):
            raise AssertionError(f"tracing: {name}: {p}")

    # ---- (c) no device op from the record ---------------------------------
    def device_ops(hold_off):
        saved = tracing._profiler_enabled
        if hold_off:
            tracing._profiler_enabled = lambda: False
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                paths["process_round_raw"](0)
                torch.cuda.synchronize()
        finally:
            tracing._profiler_enabled = saved
        return collections.Counter(
            e.name for e in pr.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)

    tracing.clear()
    with_rec, without = device_ops(False), device_ops(True)
    rec["device_ops"] = {"names": len(with_rec),
                         "launches": sum(with_rec.values()),
                         "equal": with_rec == without,
                         "rounds_recorded": len(tracing.record().rounds)}
    print(f"tracing: one profiled raw round, {rec['device_ops']['launches']} "
          f"device ops of {rec['device_ops']['names']} names with the record "
          f"on, the same with it held off: {rec['device_ops']['equal']}  "
          f"[{smi}]")
    if not rec["device_ops"]["equal"] or \
            rec["device_ops"]["rounds_recorded"] != 1:
        raise AssertionError(f"tracing: device ops differ: "
                             f"{with_rec - without} / {without - with_rec}")

    # ---- (d) the cost ----------------------------------------------------
    def per_span(make):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TRACE_SPANS):
            with make():
                pass
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t) / TRACE_SPANS

    def span_():
        return tracing.span("fit", channel=0)

    def sync_():
        return tracing.sync("refit_check")

    cost = {"span_off_us": per_span(span_), "sync_off_us": per_span(sync_)}
    with tracing.recording():
        cost["span_on_us"] = per_span(span_)
        cost["sync_on_us"] = per_span(sync_)
    def summary(rounds):
        """Medians over recorded rounds: the round's host ms, the host's
        own (less its sync spans), its syncs, and event intervals (ms a
        round; a fit's and a seeding's, ms a channel); the device
        constants the rounds built, in all."""
        med = statistics.median
        out = {"rounds": len(rounds),
               "round_host_ms": med(g[0].host_ms for g in rounds),
               "host_own_ms": med(g[0].host_ms - sum(
                   s.host_ms for s in g if s.name == "sync") for g in rounds),
               "syncs": med(g[0].attrs["syncs"] for g in rounds),
               "const_builds": sum(g[0].attrs["const_builds"] for g in rounds),
               "round_event_ms": med(g[0].device_ms for g in rounds)}
        for name in ("correct", "drift"):
            out[name + "_event_ms"] = med(sum(
                s.device_ms for s in g if s.name == name) for g in rounds)
        for name in ("fit", "seed"):
            out[name + "_event_ms"] = med(s.device_ms for g in rounds
                                          for s in g if s.name == name)
        return {k: round(v, 3) for k, v in out.items()}

    tracing.clear()
    run = paths["process_round"]
    t_rounds = {"off": [], "on": []}
    for k in range(4):
        for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
            ctx = tracing.recording() if mode == "on" else \
                contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for r in range(TRACE_ROUNDS):
                    run(r).spots.cpu()
                t_rounds[mode].append(
                    TRACE_ROUNDS / (time.perf_counter() - t))
    cost["rounds_per_s"] = t_rounds
    # the same rounds recorded without the profiler, then under it
    rec["recorded"] = summary(tracing.record().rounds)
    tracing.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t = time.perf_counter()
        for r in range(TRACE_ROUNDS):
            run(r).spots.cpu()
        rec["profiled_rounds_per_s"] = TRACE_ROUNDS / (time.perf_counter()
                                                       - t)
    rec["profiled"] = summary(tracing.record().rounds)
    tracing.clear()
    rec["cost"] = cost
    print(f"tracing: a span {cost['span_off_us']:.3f} us off, "
          f"{cost['span_on_us']:.3f} us on; a sync span "
          f"{cost['sync_off_us']:.3f} / {cost['sync_on_us']:.3f} us; rounds/s "
          f"off {[round(v, 3) for v in t_rounds['off']]}, on "
          f"{[round(v, 3) for v in t_rounds['on']]}, profiled "
          f"{rec['profiled_rounds_per_s']:.3f}  [{smi}]")
    print(f"tracing: process_round recorded without the profiler "
          f"{rec['recorded']}; under it {rec['profiled']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one round (device time by kernel)")
    ap.add_argument("--only", choices=["seed_classify", "seed_pyramid",
                                       "lm_fit", "dual_blur", "level_stencil",
                                       "gather_cubes", "gather_blocks",
                                       "dax_path", "experiment", "picking",
                                       "cell_spots", "analysis",
                                       "segmentation", "parallel",
                                       "library", "parallel_ranks",
                                       "legacy", "figures", "tracing",
                                       "lm_order"],
                    help="build this kernel alone and run its checks and "
                         "timings on the bench scene, nothing else (no "
                         "paths, no final ok line); gather_blocks times "
                         "gaussian_fit.gather_blocks whole and checks "
                         "nothing; dax_path builds the on-disk path's "
                         "kernels and runs that phase alone, experiment "
                         "the experiment driver's, picking phase 9 (no "
                         "kernel), cell_spots the per-cell path's three "
                         "kernels and phase 10, analysis phase 11's three "
                         "kernels and phase 11, segmentation the per-cell "
                         "path's three kernels and phase 12, parallel "
                         "slice 1's three kernels and phase 13, library "
                         "phase 14 (no kernel), parallel_ranks lm_fit and "
                         "the sharded round across 4 cards (needs 4), "
                         "legacy the per-cell path's three kernels and "
                         "phase 15, figures the same three and phase 16, "
                         "tracing slice 1's three kernels and phase 17, "
                         "lm_order the exact path's three kernels and the "
                         "summation-order readings of phase 5")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2

    from imageanalysis3_tpu_torch import _build
    from imageanalysis3_tpu_torch import synthetic as syn
    from imageanalysis3_tpu_torch.config import (CorrectionConfig,
                                                 ExperimentConfig, FitConfig,
                                                 SeedConfig)
    from imageanalysis3_tpu_torch.ops import (kernel_launches,
                                              reset_kernel_launches)
    from imageanalysis3_tpu_torch.ops import lm_kernel, seed_kernels
    from imageanalysis3_tpu_torch.ops.filters import gaussian_kernel1d
    from imageanalysis3_tpu_torch.ops.seeding import get_seeds
    from imageanalysis3_tpu_torch.pipeline import FovPipeline

    record = {}
    # ---- 1. setup --------------------------------------------------------
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(kind)
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    print(f"TF32 before: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; setting both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"peaks used for bounds: {peaks[2]}")
    only = {"gather_blocks": ["gather_cubes"], "dax_path": list(DAX_PATH),
            "experiment": list(PYRAMID_PATH), "picking": [],
            "cell_spots": list(CELL_PATH), "analysis": list(LEGACY_PATH),
            "segmentation": list(CELL_PATH),
            "parallel": list(PYRAMID_PATH), "library": [],
            "parallel_ranks": ["lm_fit"], "legacy": list(LEGACY_PATH),
            "figures": list(LEGACY_PATH), "tracing": list(PYRAMID_PATH),
            "lm_order": list(CELL_PATH),
            None: list(_build.KERNELS)}.get(args.only, [args.only])
    build_s = _build.build(only)
    print(f"kernel build: {build_s:.2f} s")
    for name, log in _build.build_logs.items():
        for line in _ptxas_report(log):
            print(f"  ptxas {name}: {line}")
    record.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s)
    dev = torch.device("cuda")
    if args.only == "dax_path":
        _dax_phase(torch, smi)
        return 0
    if args.only == "experiment":
        _experiment_phase(torch, smi)
        return 0
    if args.only == "picking":
        _picking_phase(torch, smi)
        return 0
    if args.only == "cell_spots":
        _cell_spots_phase(torch, smi, peaks)
        return 0
    if args.only == "analysis":
        _analysis_phase(torch, smi, peaks)
        return 0
    if args.only == "segmentation":
        _segmentation_phase(torch, smi, peaks)
        return 0
    if args.only == "parallel":
        _parallel_phase(torch, smi, dev)
        return 0
    if args.only == "library":
        _library_phase(smi)
        return 0
    if args.only == "parallel_ranks":
        _parallel_ranks_phase(torch, smi)
        return 0
    if args.only == "legacy":
        _legacy_phase(torch, smi)
        return 0
    if args.only == "figures":
        _figures_phase(torch, smi)
        return 0
    if args.only == "tracing":
        print(json.dumps(_tracing_phase(torch, smi, dev)))
        return 0
    if args.only == "lm_order":
        _lm_order_phase(torch, smi)
        return 0

    # ---- scene (bench.py's) ---------------------------------------------
    shape = SHAPE
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    truth = syn.sample_spot_params(shape, N_SPOTS, rng,
                                   min_separation=8.0,
                                   height_range=(400.0, 3000.0),
                                   sigma_jitter=0.0)
    base = syn.render_spots(shape, truth["centers"], truth["heights"],
                            background=truth["background"], device=dev)
    x = torch.linspace(-1, 1, shape[1], device=dev)[:, None]
    y = torch.linspace(-1, 1, shape[2], device=dev)[None, :]
    prof = (1.0 - 0.35 * (x * x + y * y) / 2.0).clamp(0.2, 1.0)
    ref_raw = syn.noisy_uint16(base, seed=1, illumination=prof)
    warm_raw = syn.noisy_uint16(base, seed=99, illumination=prof)
    variants = [syn.noisy_uint16(base, seed=10 + k, illumination=prof)
                for k in range(ROUNDS)]
    del base
    torch.cuda.synchronize()
    print(f"scene {shape}, {len(truth['centers'])} spots rendered in "
          f"{time.perf_counter() - t0:.2f} s")

    cfg = ExperimentConfig(
        image_size=shape, correction=CorrectionConfig(),
        seed=SeedConfig(th_seed=TH_SEED, max_num_seeds=2048),
        fit=FitConfig())
    pipe = FovPipeline(cfg, n_channels=1, drift_channel_index=0,
                       fit_channel_indices=(0,),
                       illumination=prof[None].cpu().numpy(),
                       image_shape=shape)
    corrected = [pipe.correct_one(v, 0) for v in variants[:3]]

    # ---- 2. kernels against their plain versions ------------------------
    k_fg = gaussian_kernel1d(cfg.seed.gfilt_size)
    sig_bg = cfg.seed.background_gfilt_size
    if args.only == "seed_classify":
        _seed_classify_checks(torch, seed_kernels, corrected, k_fg,
                              gaussian_kernel1d(sig_bg), peaks, smi)
        return 0
    if args.only == "seed_pyramid":
        _seed_pyramid_checks(torch, seed_kernels, corrected, k_fg, sig_bg,
                             peaks, smi)
        return 0
    if args.only == "lm_fit":
        _lm_fit_report(torch, smi)
        _lm_fit_shapes(torch, corrected, truth["centers"], peaks, smi)
        return 0
    if args.only == "dual_blur":
        _dual_blur_checks(torch, seed_kernels, corrected, k_fg,
                          gaussian_kernel1d(sig_bg), peaks, smi)
        return 0
    if args.only == "gather_cubes":
        _gather_checks(torch, corrected, truth["centers"], peaks, smi)
        return 0
    if args.only == "level_stencil":
        k_bg = gaussian_kernel1d(sig_bg)
        blurs = [seed_kernels.dual_blur_xy_plain(
            *seed_kernels.z_pass_pair(im, k_fg, k_bg), k_fg, k_bg)
            for im in corrected]
        _level_stencil_checks(torch, seed_kernels, blurs, peaks, smi)
        return 0
    if args.only == "gather_blocks":
        _gather_blocks_times(torch, corrected, truth["centers"], smi)
        return 0
    pyr = _seed_pyramid_checks(torch, seed_kernels, corrected, k_fg, sig_bg,
                               peaks, smi)
    pyr_err, pyr_ms, pyr_plain_ms = pyr["max_abs_err"], pyr["ms"], pyr["plain_ms"]
    pyr_bound = pyr["bound"]

    # the exact classifier's kernels on the same corrected stacks: the
    # z-passed pair feeds seed_classify and dual_blur, its plain blurs
    # level_stencil
    k_bg = gaussian_kernel1d(sig_bg)
    sc = _seed_classify_checks(torch, seed_kernels, corrected, k_fg, k_bg,
                               peaks, smi)
    cls, cls_gen, zpass = sc["cls"], sc["cls_gen"], sc.pop("zpass")
    cls_ms, cls_plain_ms, cls_bound = sc["ms"], sc["plain_ms"], sc["bound"]
    blurs = [seed_kernels.dual_blur_xy_plain(fgz, bgz, k_fg, k_bg)
             for fgz, bgz in zpass]
    del zpass
    lvl = _level_stencil_checks(torch, seed_kernels, blurs, peaks, smi)
    del blurs
    blur = _dual_blur_checks(torch, seed_kernels, corrected, k_fg, k_bg,
                             peaks, smi)

    # LM at the main path's round-0 shapes: blocks around the seeds
    fcfg = cfg.fit

    def lm_inputs(im):
        seeds = get_seeds(im, max_num_seeds=cfg.seed.max_num_seeds,
                          th_seed=TH_SEED, pyramid_bg=True)
        return _lm_round0(torch, im, seeds.coords.to(torch.float32),
                          seeds.valid, fcfg.radius, fcfg.lm_iters)

    lm_sets = [lm_inputs(im) for im in corrected]
    lm_in, svalid, base = (lm_sets[0][k] for k in ("lm_in", "svalid", "base"))
    n_spots, n_px = lm_in[0].shape
    lm_err, n_lm_valid, (pp, ep), lm_decided = _check_lm(
        torch, "round 0", lm_in, svalid, base, shape)
    # the Jacobi refit starts from the plain round-0 result, so kernel and
    # plain version see the same inputs
    jac_in, sel = _lm_refit(torch, lm_sets[0], pp, ep)
    jac_min_px = float(jac_in[0][jac_in[2]].min())
    jac_err, n_jac_valid, _, jac_decided = _check_lm(
        torch, "Jacobi", jac_in, svalid[sel], base[sel], shape)
    lm_err = max(lm_err, jac_err)
    lm_ms = _events_ms(torch, lm_kernel.lm_fit_cuda,
                       [st["lm_in"] for st in lm_sets], queue_ahead=True)
    lm_plain_ms = _events_ms(torch, lm_kernel.lm_fit_plain,
                             [st["lm_in"] for st in lm_sets],
                             queue_ahead=False)
    it = fcfg.lm_iters
    lm_bound = _lm_bound(n_spots, n_px, it, peaks)
    print(f"lm_fit: PASS  round 0: {n_spots} spots x {n_px} px x {it} "
          f"iters, valid {n_lm_valid}; Jacobi: {jac_in[0].shape[0]} spots x "
          f"{jac_in[8]} iters, valid {n_jac_valid}, least subtracted pixel "
          f"{jac_min_px:.4g}; max |dcentre| {lm_err:.3g} px; decided by "
          f"the summation order {lm_decided} / {jac_decided}")
    print(f"kernels: seed_pyramid PASS {pyr_ms:.4f} ms (plain "
          f"{pyr_plain_ms:.4f} ms, bound {pyr_bound[0]:.4f} ms by "
          f"{pyr_bound[1]}); lm_fit PASS {lm_ms:.4f} ms (plain "
          f"{lm_plain_ms:.4f} ms, bound {lm_bound[0]:.4f} ms by "
          f"{lm_bound[1]})  [{smi}]")
    lm_report = _lm_fit_report(torch, smi)
    lm_shapes = _lm_fit_shapes(torch, corrected, truth["centers"], peaks, smi)
    gather = _gather_checks(torch, corrected, truth["centers"], peaks, smi)
    del pp, ep, lm_sets, lm_in, jac_in, corrected

    # ---- 3. main path ----------------------------------------------------
    def check_accuracy(label, res):
        return _check_accuracy(label, res, truth["centers"])

    ref_im = pipe.prepare_reference(pipe.correct_reference(ref_raw[None]))
    res = pipe.process_round(warm_raw[None], ref_im)
    torch.cuda.synchronize()
    med_err, n_valid = check_accuracy("warm round", res)
    del res

    times, per_round, outs = [], [], []
    total = {name: 0 for name in PYRAMID_PATH}
    for v in variants:
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        out = pipe.process_round(v[None], ref_im)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = kernel_launches()
        per_round.append(counts)
        for name in PYRAMID_PATH:
            if counts[name] < 1:
                raise AssertionError(f"kernel {name} did not launch in a "
                                     f"main-path round: {counts}")
            total[name] += counts[name]
        outs.append(out)
    # outside the timed region: every timed round meets the same gate
    round_accuracy = [check_accuracy(f"timed round {i}", out)
                      for i, out in enumerate(outs)]
    del outs, out
    sec = statistics.median(times)

    def stage(fn, inputs):
        fn(inputs[0])
        torch.cuda.synchronize()
        ts = []
        for a in inputs[1:]:
            t0 = time.perf_counter()
            fn(a)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    raw3 = [v for v in variants[:3]]
    stages = {"correct": stage(lambda v: pipe.correct_one(v, 0), raw3)}
    corr3 = [pipe.correct_one(v, 0) for v in raw3]
    stages["drift"] = stage(lambda c: pipe.drift_of(c, ref_im), corr3)
    stages["fit"] = stage(lambda c: pipe.fit_channel(c, TH_SEED), corr3)
    print(f"main path: {sec:.4f} s/stack (median of {len(times)} rounds "
          f"{[round(t, 4) for t in times]}), stages "
          f"{ {k: round(v, 4) for k, v in stages.items()} } s, launches per "
          f"round {per_round}  [{smi}]")
    if args.profile:
        record["profile"] = _profile_round(torch, pipe, variants[0], ref_im,
                                           smi)
    del pipe, ref_im, variants, raw3, corr3, ref_raw, warm_raw
    torch.cuda.empty_cache()

    # ---- 4. the dual-blur and level-stencil paths -------------------------
    record["dual_blur_path"] = dual = _dual_blur_phase(torch, smi)
    torch.cuda.empty_cache()

    # ---- 5. the end-to-end path (exact classifier) ------------------------
    record["e2e"] = e2e = _e2e_phase(torch, smi)
    decoded = e2e.pop("decoded")
    torch.cuda.empty_cache()
    # its fits against the plain version in other summation orders
    record["lm_order"] = _lm_order_phase(torch, smi)
    torch.cuda.empty_cache()

    # ---- 6. the bead-calibration path ---------------------------------------
    record["calibration"] = calib = _calibration_phase(torch, smi)
    torch.cuda.empty_cache()

    # ---- 7. the on-disk .dax path -------------------------------------------
    record["dax_path"] = dax = _dax_phase(torch, smi)
    dax_launches = dax["total_launches"]
    torch.cuda.empty_cache()

    # ---- 8. the experiment driver ---------------------------------------------
    record["experiment"] = exp = _experiment_phase(torch, smi)
    exp_launches = exp["total_launches"]
    torch.cuda.empty_cache()

    # ---- 9. picking at a lab's width ------------------------------------------
    record["picking"] = _picking_phase(torch, smi, decoded)
    del decoded
    torch.cuda.empty_cache()

    # ---- 10. the per-cell spot path -------------------------------------------
    record["cell_spots"] = cell = _cell_spots_phase(torch, smi, peaks)
    cell_launches, cell_kernels = cell["launches"], cell["kernels"]
    torch.cuda.empty_cache()

    # ---- 11. polymer post-analysis and the rest of ops/ -----------------------
    record["analysis"] = ana = _analysis_phase(torch, smi, peaks)
    ana_launches = ana["launches"]
    torch.cuda.empty_cache()

    # ---- 12. segmentation ----------------------------------------------------
    record["segmentation"] = seg = _segmentation_phase(torch, smi, peaks)
    seg_launches = seg["launches"]
    torch.cuda.empty_cache()

    # ---- 13. parallel/ under a world-size-1 NCCL group ---------------------
    record["parallel"] = par = _parallel_phase(torch, smi, dev)
    par_launches = par["total_launches"]
    torch.cuda.empty_cache()

    # ---- 14. library/ on the host ----------------------------------------------
    record["library"] = _library_phase(smi)
    torch.cuda.empty_cache()

    # ---- 15. the legacy CellList / CellData facade -----------------------------
    record["legacy"] = leg = _legacy_phase(torch, smi)
    leg_launches = leg["total_launches"]
    torch.cuda.empty_cache()

    # ---- 16. figures/ (where matplotlib imports) --------------------------------
    record["figures"] = fig = _figures_phase(torch, smi)
    fig_launches = fig.get("total_launches",
                           {k: None for k in LEGACY_PATH})
    torch.cuda.empty_cache()

    # ---- 17. the span record ---------------------------------------------------
    record["tracing"] = _tracing_phase(torch, smi, dev)
    torch.cuda.empty_cache()

    kernels = [
        {"name": "seed_pyramid", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/seed_pyramid.cu",
         "replaces": "imageanalysis3_tpu/ops/pallas_kernels.py:861",
         "launches": total["seed_pyramid"], "max_abs_err": pyr_err,
         "ms": pyr_ms, "plain_ms": pyr_plain_ms, "bound_ms": pyr_bound[0],
         "bound_by": pyr_bound[1], "library_ms": None,
         "dax_path_launches": dax_launches["seed_pyramid"],
         "experiment_launches": exp_launches["seed_pyramid"],
         "parallel_launches": par_launches["seed_pyramid"]},
        {"name": "lm_fit", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/lm_fit.cu",
         "replaces": "imageanalysis3_tpu/ops/pallas_lm.py:225",
         "launches": total["lm_fit"], "max_abs_err": lm_err,
         "ms": lm_ms, "plain_ms": lm_plain_ms, "bound_ms": lm_bound[0],
         "bound_by": lm_bound[1], "library_ms": None,
         "dax_path_launches": dax_launches["lm_fit"],
         "experiment_launches": exp_launches["lm_fit"],
         "cell_spots_launches": cell_launches["lm_fit"],
         "analysis_launches": ana_launches["lm_fit"],
         "segmentation_launches": seg_launches["lm_fit"],
         "parallel_launches": par_launches["lm_fit"],
         "legacy_launches": leg_launches["lm_fit"],
         "figures_launches": fig_launches["lm_fit"],
         "shapes": {k: {f: v[f] for f in ("spots", "px", "iters", "ms",
                                          "plain_ms", "bound_ms",
                                          "max_abs_err")}
                    for k, v in {**lm_shapes, **{
                        f"cell crop {k[len('lm_fit '):]}": v
                        for k, v in cell_kernels.items()
                        if k.startswith("lm_fit")},
                        **ana["ops"]["lm_fit"]}.items()}},
        {"name": "seed_classify", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/seed_classify.cu",
         "replaces": "imageanalysis3_tpu/ops/pallas_kernels.py:522",
         "launches": e2e["seed_classify_launches"],
         "max_abs_err": cls["max_abs_err"], "ms": cls_ms,
         "plain_ms": cls_plain_ms, "bound_ms": cls_bound[0],
         "bound_by": cls_bound[1], "library_ms": None,
         "dax_path_launches": dax_launches["seed_classify"],
         "cell_spots_launches": cell_launches["seed_classify"],
         "analysis_launches": ana_launches["seed_classify"],
         "segmentation_launches": seg_launches["seed_classify"],
         "legacy_launches": leg_launches["seed_classify"],
         "figures_launches": fig_launches["seed_classify"],
         "cell_crop": {k: cell_kernels["seed_classify"][k]
                       for k in ("shape", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "max_abs_err")}},
        {"name": "dual_blur", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/dual_blur.cu",
         "replaces": "imageanalysis3_tpu/ops/pallas_kernels.py:280",
         "launches": sum(c["dual_blur"] for c in dual["launches_per_round"]),
         "max_abs_err": blur["max_abs_err"], "ms": blur["ms"],
         "plain_ms": blur["plain_ms"], "bound_ms": blur["bound"][0],
         "bound_by": blur["bound"][1], "library_ms": None,
         "shapes": blur["shapes"]},
        {"name": "level_stencil", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/level_stencil.cu",
         "replaces": "imageanalysis3_tpu/ops/pallas_kernels.py:120",
         "launches": dual["level_stencil_launches"]["level_stencil"],
         "max_abs_err": lvl["max_abs_err"], "ms": lvl["ms"],
         "plain_ms": lvl["plain_ms"], "bound_ms": lvl["bound"][0],
         "bound_by": lvl["bound"][1], "library_ms": None,
         "shapes": lvl["shapes"]},
        {"name": "gather_cubes", "route": "cuda",
         "source": "imageanalysis3_tpu_torch/csrc/gather_cubes.cu",
         "replaces": "scripts/ab_gather2.py:62",
         "launches": total["gather_cubes"],
         "max_abs_err": max(c["max_abs_err"]
                            for entry in ("cubes", "ball")
                            for c in gather[entry].values()),
         **{k: gather["ball"]["slice1"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")},
         "dax_path_launches": dax_launches["gather_cubes"],
         "experiment_launches": exp_launches["gather_cubes"],
         "cell_spots_launches": cell_launches["gather_cubes"],
         "analysis_launches": ana_launches["gather_cubes"],
         "segmentation_launches": seg_launches["gather_cubes"],
         "parallel_launches": par_launches["gather_cubes"],
         "legacy_launches": leg_launches["gather_cubes"],
         "figures_launches": fig_launches["gather_cubes"],
         "entries": {"ball": {**gather["ball"],
                              "cell_crop": cell_kernels["gather_cubes"],
                              **{f"analysis {k}": v for k, v in
                                 ana["ops"]["gather"].items()}},
                     "cubes": gather["cubes"],
                     "gather_blocks": gather["gather_blocks"]}},
    ]
    record.update(
        shape=shape, n_spots=len(truth["centers"]), kernels=kernels,
        max_abs_err_definition={
            "seed_pyramid": "max |qdiff kernel - plain| over voxels both "
                            "qualify (intensity units); the kernel is held "
                            "equal (torch.equal) to its plain version",
            "lm_fit": "max |centre kernel - plain| over valid spots (px)",
            "seed_classify": "max |qdiff kernel - plain| over voxels both "
                             "qualify (intensity units); the default taps' "
                             "bg runs as split-TF32 products on the tensor "
                             "cores and is held by tolerance (qualification "
                             "on > 1 - 1e-5 of voxels, qdiff rtol 1e-4 / "
                             "atol 0.05, counts within 2), not bit for bit; "
                             "the run-time-radius path is bit-identical",
            "dual_blur": "max |blur kernel - plain| over both stacks "
                         "(intensity units); fg bit-identical; the default "
                         "taps' bg runs as split-TF32 products on the "
                         "tensor cores and is held by rtol 2e-5 / atol "
                         "2e-2, the run-time-radius path bit for bit",
            "level_stencil": "max |diff kernel - plain| (intensity units)",
            "gather_cubes": "max |kernel - plain| over every case of both "
                            "entries (cubes; ball pixels, coords, mask); "
                            "both are held equal (torch.equal); ms, plain "
                            "and library ms and the bound are the ball "
                            "entry's at slice 1's 2048 seeds, r = 5"},
        kernel_checks={"seed_pyramid": pyr, "seed_classify": cls,
                       "seed_classify_generic_radius": cls_gen,
                       "seed_classify_full_range": sc["cls_full"],
                       "seed_classify_odd_shape": sc["cls_odd"],
                       "seed_classify_mma_layout_err": sc["mma_layout_err"],
                       "seed_classify_flat_qualified": sc["flat_qualified"],
                       "seed_classify_byte_bound_ms": sc["byte_bound_ms"],
                       "dual_blur": blur,
                       "level_stencil": lvl, "gather_cubes": gather,
                       "lm_fit_shapes": lm_shapes, "lm_fit_build": lm_report},
        seconds_per_stack=sec, round_seconds=times, stage_seconds=stages,
        launches_per_round=per_round, median_centroid_err_px=med_err,
        n_valid=n_valid, timed_round_accuracy=round_accuracy,
        peak_memory_bytes=max(calib["earlier_peak_memory_bytes"],
                              torch.cuda.max_memory_allocated()))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    record["script_s"] = time.perf_counter() - t_script
    print(f"chip_smoke: whole script {record['script_s']:.1f} s  [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
