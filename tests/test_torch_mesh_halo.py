"""The port's mesh, padding and halo exchange (crdmodel_tpu_torch/parallel/
mesh.py, padding.py, halo.py) against the JAX package's on its 8 virtual
CPU devices: the factorisation, the pad plan, and every shard's halo-padded
block of halo_pad (with the seam legs of a padded grid) and of the mirror
exchange the fused shard kernels run on, each equal to JAX's bitwise.
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.parallel import halo as th
from crdmodel_tpu_torch.parallel.mesh import balanced_dims, make_mesh
from crdmodel_tpu_torch.parallel.padding import compute_pad_spec

MESHES = [(1, 1), (2, 4), (4, 2), (8, 1), (1, 8)]


def _jax():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return jax


def _blocks(a, shape):
    """The (py, px) blocks of a global array, row-major, as CPU tensors."""
    py, px = shape
    nyl, nxl = a.shape[-2] // py, a.shape[-1] // px
    return [torch.tensor(a[..., iy * nyl:(iy + 1) * nyl,
                           ix * nxl:(ix + 1) * nxl])
            for iy in range(py) for ix in range(px)]


def _jax_blocks(fn, a, shape, lead=0):
    """fn under JAX's shard_map on a (py, px) mesh, every device's output
    block, row-major."""
    jax = _jax()
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh

    spec = P(*([None] * lead), AXIS_Y, AXIS_X)
    out = np.asarray(jax.jit(jax.shard_map(
        lambda x: fn(x)[None], mesh=jmake_mesh(shape=shape), in_specs=spec,
        out_specs=P(None, *([None] * lead), AXIS_Y, AXIS_X)))(
            jnp.asarray(a)))[0]
    return [b.numpy() for b in _blocks(out, shape)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8])
def test_balanced_dims_matches_jax(n):
    from crdmodel_tpu.parallel.mesh import balanced_dims as jbalanced
    for ny, nx in [(1600, 400), (400, 1600), (39, 17), (40, 17), (10, 10),
                   (6400, 1600), (4, 4), (13, 39), (7, 1)]:
        try:
            want = jbalanced(n, ny, nx)
        except ValueError:
            with pytest.raises(ValueError):
                balanced_dims(n, ny, nx)
            continue
        assert balanced_dims(n, ny, nx) == want


def test_make_mesh():
    mesh = make_mesh(shape=(2, 3), devices=["cpu"] * 8)
    assert mesh.shape == (2, 3) and mesh.size == 6
    assert mesh.control == torch.device("cpu")
    assert make_mesh(n_devices=4, grid_shape=(1600, 400),
                     devices=["cpu"] * 4).shape == balanced_dims(4, 1600, 400)
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh(shape=(3, 3), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="shape or grid_shape"):
        make_mesh(n_devices=2, devices=["cpu"] * 2)


@pytest.mark.parametrize("p", [1, 8, 24])
@pytest.mark.parametrize("shape", MESHES)
def test_halo_pad_matches_jax(shape, p):
    from crdmodel_tpu.parallel.halo import halo_pad as jhalo_pad
    a = np.random.default_rng(p).standard_normal((2, 192, 192))
    want = _jax_blocks(lambda x: jhalo_pad(x, p=p), a, shape, lead=1)
    mesh = make_mesh(shape=shape, devices=["cpu"] * 8)
    got = th.halo_pad(_blocks(a, shape), mesh, p)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {k}")


@pytest.mark.parametrize("ny,nx,shape,p", [
    (39, 13, (2, 4), 1), (37, 29, (4, 2), 1), (39, 13, (8, 1), 1),
    (41, 23, (2, 2), 2), (13, 39, (1, 8), 1)])
def test_seam_halo_pad_matches_jax(ny, nx, shape, p):
    """halo_pad with the seam legs of a padded grid, pad cells included."""
    from crdmodel_tpu.parallel.halo import halo_pad as jhalo_pad
    spec = compute_pad_spec(ny, nx, *shape)
    a = spec.pad_field(np.random.default_rng(ny).standard_normal((ny, nx)))
    want = _jax_blocks(lambda x: jhalo_pad(x, p=p, seam_y=spec.seam_y(),
                                           seam_x=spec.seam_x()), a, shape)
    mesh = make_mesh(shape=shape, devices=["cpu"] * 8)
    got = th.halo_pad(_blocks(a, shape), mesh, p, spec.seam_y(),
                      spec.seam_x())
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {k}")


def test_seam_halo_wider_than_last_shard_raises():
    spec = compute_pad_spec(33, 16, 2, 1)       # seam shard holds 16 rows
    assert spec.seam_y() == (1, 15)
    mesh = make_mesh(shape=(2, 1), devices=["cpu"] * 2)
    blocks = _blocks(spec.pad_field(np.zeros((33, 16))), (2, 1))
    with pytest.raises(ValueError, match="spans shards"):
        th.halo_pad(blocks, mesh, 17, spec.seam_y())


@pytest.mark.parametrize("ny,nx,shape,p", [
    (39, 13, (2, 2), 4), (100, 50, (3, 1), 24), (50, 100, (1, 3), 24),
    (45, 37, (2, 4), 4), (400, 40, (1, 3), 8)])
def test_mirror_halo_pad_matches_jax(ny, nx, shape, p):
    """The fused kernels' exchange on a padded grid: refresh_halos (through
    mirror_halo_pad) equals JAX's two-phase mirror_halo_pad on every
    shard, and every halo-padded block is the n-periodic extension."""
    from crdmodel_tpu.parallel.halo import mirror_halo_pad as jmirror
    spec = compute_pad_spec(ny, nx, *shape)
    u = np.random.default_rng(nx).standard_normal((2, ny, nx))
    a = spec.pad_field(u)
    want = _jax_blocks(lambda x: jmirror(x, "py", "px", p, spec), a, shape,
                       lead=1)
    mesh = make_mesh(shape=shape, devices=["cpu"] * 8)
    got = th.mirror_halo_pad(_blocks(a, shape), mesh, p, spec)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {k}")
        iy, ix = divmod(k, shape[1])
        rows = (iy * spec.y.blk - p + np.arange(spec.y.blk + 2 * p)) % ny
        cols = (ix * spec.x.blk - p + np.arange(spec.x.blk + 2 * p)) % nx
        np.testing.assert_array_equal(g.numpy(), u[:, rows][:, :, cols])


@pytest.mark.parametrize("shape", MESHES)
def test_refresh_halos_in_place(shape):
    """refresh_halos rewrites stale halos of persistent buffers in place,
    to exactly halo_pad's result on an even grid."""
    a = np.random.default_rng(5).standard_normal((2, 64, 64))
    mesh = make_mesh(shape=shape, devices=["cpu"] * 8)
    want = th.halo_pad(_blocks(a, shape), mesh, 8)
    bufs = [w.clone() for w in want]
    for b in bufs:
        b[..., :8, :] = np.nan
        b[..., :, -8:] = np.nan
    ptrs = [b.data_ptr() for b in bufs]
    got = th.refresh_halos(bufs, mesh, 8)
    assert [g.data_ptr() for g in got] == ptrs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_mirror_halo_wider_than_block_raises():
    spec = compute_pad_spec(39, 13, 8, 1)       # blocks of 5 rows
    mesh = make_mesh(shape=(8, 1), devices=["cpu"] * 8)
    blocks = _blocks(spec.pad_field(np.zeros((39, 13))), (8, 1))
    with pytest.raises(ValueError, match="exceeds the block size"):
        th.mirror_halo_pad(blocks, mesh, 8, spec)


@pytest.mark.parametrize("n,size,blk,p", [
    (39, 4, 10, 8), (13, 2, 7, 7), (5, 8, 1, 1), (39, 1, 39, 8)])
def test_mirror_halo_rows_matches_periodic_extension(n, size, blk, p):
    """The one-axis mirror pads reproduce the n-periodic extension's halos
    for every shard, pure-pad shards included
    (tests/test_uneven.py:182-205)."""
    u = np.random.default_rng(3).standard_normal((2, n, 7))
    reps = -(-(size * blk) // n)
    up = np.concatenate([u] * reps, axis=1)[:, :size * blk]
    mesh = make_mesh(shape=(size, 1), devices=["cpu"] * 8)
    out = th.mirror_halo_pad_rows(_blocks(up, (size, 1)), mesh, p, n, blk)
    cols = th.mirror_halo_pad_cols(
        _blocks(np.swapaxes(up, 1, 2), (1, size)),
        make_mesh(shape=(1, size), devices=["cpu"] * 8), p, n, blk)
    for s in range(size):
        rows = (s * blk - p + np.arange(blk + 2 * p)) % n
        np.testing.assert_array_equal(out[s].numpy(), u[:, rows])
        np.testing.assert_array_equal(cols[s].numpy(),
                                      np.swapaxes(u[:, rows], 1, 2))


@pytest.mark.parametrize("ny,nx,py,px", [
    (39, 13, 2, 4), (40, 16, 2, 4), (400, 1600, 3, 1), (1600, 400, 1, 3),
    (5, 39, 8, 1), (37, 37, 3, 3)])
def test_pad_spec_matches_jax(ny, nx, py, px):
    """PadSpec's fields, wrap fills, unpad and valid mask equal JAX's
    (tests/test_uneven.py:38-64) with the port's layout, blocks without
    the TPU's 8-row rounding."""
    from crdmodel_tpu.parallel.padding import compute_pad_spec as jspec
    want, got = jspec(ny, nx, py, px), compute_pad_spec(ny, nx, py, px)
    assert got.padded_shape == want.padded_shape
    assert (got.seam_y(), got.seam_x()) == (want.seam_y(), want.seam_x())
    assert (got.y.blk, got.x.blk, got.active) == (want.y.blk, want.x.blk,
                                                  want.active)
    a = np.arange(2 * ny * nx, dtype=np.float64).reshape(2, ny, nx)
    np.testing.assert_array_equal(got.pad_field(a),
                                  np.asarray(want.pad_field(a)))
    np.testing.assert_array_equal(
        got.pad_field(torch.tensor(a)).numpy(), np.asarray(want.pad_field(a)))
    np.testing.assert_array_equal(got.pad_rows(a[0, :, :1]),
                                  np.asarray(want.pad_rows(a[0, :, :1])))
    np.testing.assert_array_equal(got.pad_cols(a[0, 0]),
                                  np.asarray(want.pad_cols(a[0, 0])))
    np.testing.assert_array_equal(got.unpad_field(got.pad_field(a)), a)
    np.testing.assert_array_equal(got.valid_mask(), want.valid_mask())


def test_pad_layout_differs_from_jax_fused():
    """The port takes any block height; the JAX package rounds blocks to 8
    rows on its fused path: 400 rows on 3 shards give it 136, the port
    134 (the last shard 128 and 132 physical rows)."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.parallel.padding import pad_spec_for as jpad_spec_for

    from crdmodel_tpu_torch.config import SimConfig
    from crdmodel_tpu_torch.parallel.padding import pad_spec_for
    kw = dict(model="fhn", surface="flat", x_mesh=400, surface_width=20.0,
              surface_length=20.0, use_pallas=True, dtype="float32")
    assert pad_spec_for(SimConfig(**kw), 3, 1).y.blk == 134
    assert jpad_spec_for(JSimConfig(**kw), 3, 1).y.blk == 136
