"""The port's copies of the numpy-only utilities (`utils/seq.py`,
`utils/geometry.py`) and its meters (`utils/meters.py`) against the JAX
package's, on the CPU: tests/test_utils_misc.py's and
tests/test_geometry.py's cases, each output equal to JAX's on the same
inputs (exactly: the same numpy code), and the mesh extraction driven by
the port's `RADNeRF.density`."""

import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.utils import geometry as j_geometry
from genefaceplusplus_tpu.utils import seq as j_seq
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF, RADNeRFConfig
from genefaceplusplus_tpu_torch.utils import geometry as t_geometry
from genefaceplusplus_tpu_torch.utils import seq as t_seq
from genefaceplusplus_tpu_torch.utils.meters import AvgrageMeter, Timer


def test_collate():
    a = [np.ones(3), np.arange(5.0)]
    out = t_seq.collate_1d(a, pad_value=-1)
    assert out.shape == (2, 5) and out[0, 3] == -1
    np.testing.assert_array_equal(out, j_seq.collate_1d(a, pad_value=-1))
    b = [np.ones((3, 4)), np.ones((5, 4))]
    out2 = t_seq.collate_2d(b, max_len=6)
    assert out2.shape == (2, 6, 4)
    np.testing.assert_array_equal(out2, j_seq.collate_2d(b, max_len=6))
    m = t_seq.sequence_mask(np.asarray([3, 5]))
    assert m.shape == (2, 5) and m[0].sum() == 3
    np.testing.assert_array_equal(m, j_seq.sequence_mask(np.asarray([3, 5])))
    x, r = np.arange(6).reshape(3, 2), np.asarray([2, 0, 1])
    np.testing.assert_array_equal(t_seq.expand_by_repeat_times(x, r), j_seq.expand_by_repeat_times(x, r))


def test_meters():
    m = AvgrageMeter()
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0
    m.update(5.0, n=2)
    assert m.avg == 3.5 and m.cnt == 4
    with Timer("t_port", print_interval=1000, sync=torch.zeros(1)):
        pass
    assert Timer.counts["t_port"] == 1 and Timer.totals["t_port"] >= 0.0
    with Timer("t_port_off", enable=False):
        pass
    assert Timer.counts["t_port_off"] == 0


def _sphere(R=48):
    xs = np.linspace(-1, 1, R, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return 1.0 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)  # iso 0.5: the r = 0.5 sphere


def test_sphere_isosurface():
    verts, tris = t_geometry.marching_tetrahedra(_sphere(), 0.5, bound=1.0)
    j_verts, j_tris = j_geometry.marching_tetrahedra(_sphere(), 0.5, bound=1.0)
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(tris, j_tris)
    assert len(verts) > 100 and len(tris) > 100
    radii = np.linalg.norm(verts, axis=-1)
    np.testing.assert_allclose(radii.mean(), 0.5, atol=0.03)
    assert radii.std() < 0.03
    assert tris.min() >= 0 and tris.max() < len(verts)


@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_empty_and_full_fields(fill):
    v, t = t_geometry.marching_tetrahedra(np.full((8, 8, 8), fill, np.float32), 0.5)
    assert v.shape == (0, 3) and t.shape == (0, 3)


def test_extract_geometry_from_density_fn():
    def density(pts):
        return 20.0 * (np.linalg.norm(pts, axis=-1) < 0.4)

    verts, tris = t_geometry.extract_geometry(density, resolution=32, threshold=10.0, bound=1.0)
    j_verts, j_tris = j_geometry.extract_geometry(density, resolution=32, threshold=10.0, bound=1.0)
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(tris, j_tris)
    assert len(verts) > 50
    assert 0.3 < np.linalg.norm(verts, axis=-1).mean() < 0.5


def test_extract_geometry_from_radnerf_density():
    """A seeded head's sigma (`RADNeRF.density` at a zero condition) on a
    24^3 lattice, cut at its median: a non-empty mesh inside the bound,
    JAX's code giving the same mesh on the same callable."""
    cfg = RADNeRFConfig(grid_size=16, smo_win_size=3, individual_embedding_num=4)
    head = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).eval()
    cond = torch.zeros(1, cfg.cond_out_dim)

    def density(pts):
        with torch.no_grad():
            return head.density(torch.from_numpy(pts), cond).numpy()

    xs = np.linspace(-cfg.bound, cfg.bound, 24, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    threshold = float(np.median(density(grid)))
    verts, tris = t_geometry.extract_geometry(density, resolution=24, threshold=threshold, bound=cfg.bound)
    j_verts, j_tris = j_geometry.extract_geometry(density, resolution=24, threshold=threshold, bound=cfg.bound)
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(tris, j_tris)
    assert len(tris) > 100 and np.abs(verts).max() <= cfg.bound + 1e-6
