"""PyTorch port vs JAX package: trace conditioning on the CPU, and the
per-cell spot path's core without pandas or h5py.

``nan_gaussian_filter`` (1-D traces, a 2-D map, ``keep_nan``, an all-NaN
window), ``interp1dnan``, ``interpolate_chr`` (with and without the
smoothing, one anchor, none) and ``extract_sequences``, held at atol 1e-6
against the JAX functions on seeded traces in um.  The smoothing is
float32 in both packages: up to 9 taps both sum tap by tap, wider kernels
are one band matmul whose sums run in another order than XLA's dot, so
there the two agree to a few float32 ulps (rtol 1e-6 beside the atol;
tests/test_torch_filters.py holds the filter itself at rtol 1e-5).  Then
the port imports and runs its column-table core (spot tables, ``.npy``
files, ``SpotMapper``, ``SpotPicker``, ``batch_pick_spots``) in a process
where pandas and h5py are hidden, as on the card machine.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.analysis import traces as jtr
from imageanalysis3_tpu_torch.analysis import traces as ttr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _trace(n=60, seed=0, missing=0.25):
    """A random-walk trace in um (0.3 um steps) with NaN rows."""
    rng = np.random.default_rng(seed)
    zxy = 5.0 + np.cumsum(rng.normal(0, 0.3 / np.sqrt(3), (n, 3)), 0)
    zxy[rng.uniform(size=n) < missing] = np.nan
    zxy[3, 1] = np.nan                     # a partly missing row
    return zxy


@pytest.mark.parametrize("sigma,keep_nan", [(0.5, False), (1.0, True),
                                            (1.5, False), (3.0, True)])
def test_nan_gaussian_filter_matches_jax(sigma, keep_nan):
    tr = _trace()
    rtol = 0.0 if sigma < 1.5 else 1e-6          # > 9 taps: a band matmul
    for mat in (tr[:, 0], tr, np.full(12, np.nan)):
        want = np.asarray(jtr.nan_gaussian_filter(jnp.asarray(mat), sigma,
                                                  keep_nan=keep_nan))
        got = ttr.nan_gaussian_filter(mat, sigma, keep_nan=keep_nan,
                                      device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                   rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("gaussian", [0.0, 1.0, 2.5])
def test_interpolate_chr_matches_jax(gaussian):
    rtol = 0.0 if gaussian < 1.5 else 1e-6       # > 9 taps: a band matmul
    for seed, missing in ((1, 0.25), (2, 0.6)):
        tr = _trace(seed=seed, missing=missing)
        want = jtr.interpolate_chr(tr, gaussian=gaussian)
        got = ttr.interpolate_chr(torch.from_numpy(tr), gaussian=gaussian)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=rtol)
    one = np.full((8, 3), np.nan)
    one[4] = [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(ttr.interpolate_chr(one),
                                  jtr.interpolate_chr(one))
    none = np.full((5, 3), np.nan)
    np.testing.assert_array_equal(ttr.interpolate_chr(none), none)
    with pytest.raises(ValueError):
        ttr.interpolate_chr(np.zeros(4))


def test_interp1dnan_and_sequences_match_jax():
    tr = _trace(seed=3)
    for col in (tr[:, 0], tr[:, 1], np.full(4, np.nan), np.arange(5.0)):
        np.testing.assert_array_equal(ttr.interp1dnan(col),
                                      jtr.interp1dnan(col))
    for starts in ([0, 10, 25], [0], [0, 59]):
        got = ttr.extract_sequences(torch.from_numpy(tr), starts)
        want = jtr.extract_sequences(tr, starts)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    x = np.arange(10.0)
    xp, fp = np.array([2.0, 4.0, 7.0]), np.array([1.0, -1.0, 5.0])
    np.testing.assert_array_equal(ttr._interp_linear_extrap(x, xp, fp),
                                  jtr._interp_linear_extrap(x, xp, fp))


CORE_WITHOUT_PANDAS = r"""
import os, sys, tempfile
sys.modules['h5py'] = None
sys.modules['pandas'] = None
import numpy as np, torch
from imageanalysis3_tpu_torch.io import spots as sio
from imageanalysis3_tpu_torch.decode import SpotMapper, SpotPicker
from imageanalysis3_tpu_torch.decode.picker import batch_pick_spots
from imageanalysis3_tpu_torch.spots import reconstruct_spot_image
from imageanalysis3_tpu_torch.analysis import spots_to_labels, interpolate_chr

rng = np.random.default_rng(0)
tmp = tempfile.mkdtemp()
n_reg = 12
spots = np.zeros((3 * n_reg, 11))
spots[:, 0] = np.tile([1200.0, 1100.0, 300.0], n_reg)
spots[:, 1:4] = rng.uniform(5, 40, (3 * n_reg, 3))
spots[:, 5:8] = 1.5
bits = np.repeat(np.arange(1, n_reg + 1), 3)
table = sio.spots_to_table(spots, bits, ['750'] * len(bits), fov_id=0,
                           cell_id=np.ones(len(bits), int), uid='f0')
path = os.path.join(tmp, 'cell.tables')
sio.save_table_hdf5(table, path, 'cand_spots')
back = sio.load_table_hdf5(path, 'cand_spots')
assert all(np.array_equal(back[c], table[c]) for c in table), 'npy'
cb = {'name': np.asarray([f'1:{i * 10**6}-{i * 10**6 + 5 * 10**5}'
                          for i in range(n_reg)]),
      'id': np.arange(n_reg), 'chr': np.full(n_reg, '1')}
for b in range(n_reg):
    cb[str(b + 1)] = (np.arange(n_reg) == b).astype(int)
mapped = SpotMapper(back, cb).filtered_spots
coords = {'region_name': mapped['region_name'], 'chr': mapped['chr'],
          'center_z': mapped['z'] * 200.0, 'center_x': mapped['x'] * 108.0,
          'center_y': mapped['y'] * 108.0,
          'center_intensity': mapped['height']}
picker = SpotPicker(coords, cb, chr_2_copy_num={'1': 2}, device='cpu')
picker.iterative_assignment(max_niter=5)
dec = os.path.join(tmp, 'decoded')
sio.save_table_hdf5(coords, dec, 'libA/candSpots')
sio.save_table_hdf5(cb, dec, 'libA/codebook')
again = batch_pick_spots(dec, os.path.join(tmp, 'picked'),
                         num_expected_lib=1, chr_2_copy_num={'1': 2},
                         device='cpu')
assert torch.equal(again.chr_2_homolog_inds['1'],
                   picker.chr_2_homolog_inds['1'])
loaded = SpotPicker.load_picked(os.path.join(tmp, 'picked'), device='cpu')
assert torch.equal(loaded.chr_2_homolog_inds['1'],
                   picker.chr_2_homolog_inds['1'])
im = reconstruct_spot_image(spots, (48, 48, 48), device='cpu')
lab = spots_to_labels(np.ones((48, 48, 48), np.int32), spots[:, 1:4],
                      np.ones(len(spots), bool), device='cpu')
assert (lab == 1).all() and float(im.max()) > 0.5
trace = picker.chr_2_homolog_hzxys['1'][0, :, 1:]
assert interpolate_chr(trace).shape == (n_reg, 3)
bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')
       or m == 'imageanalysis3_tpu' or m.startswith('imageanalysis3_tpu.')]
assert not bad, bad
print('ok')
"""


def test_core_runs_without_pandas_or_h5py():
    out = subprocess.run([sys.executable, "-c", CORE_WITHOUT_PANDAS],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
