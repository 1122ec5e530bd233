"""The on-device tracer and ray bank, held against the repository's
procedural scene generator (a test-time comparison only: the benchmark
never imports the generator)."""

import numpy as np
import pytest
import torch

from harness import scene


@pytest.mark.parametrize("theta,phi", [(30.0, -30.0), (-120.0, -50.0),
                                       (170.0, -15.0)])
def test_tracer_matches_the_procedural_scene(theta, phi):
    procedural = pytest.importorskip(
        "nerf_replication_tpu_torch.datasets.procedural")
    from nerf_replication_tpu_torch.datasets.rays import pose_spherical

    c2w = pose_spherical(theta, phi, 4.0)
    assert np.array_equal(c2w, scene.pose_spherical(theta, phi, 4.0))
    focal = scene.focal_for(64)
    want = procedural.render_view(64, 64, focal, c2w).reshape(-1, 4)
    o, d = scene.camera_rays(64, 64, focal, torch.from_numpy(c2w))
    got = scene.trace_rgba8(o, d).numpy()
    assert np.array_equal(got, want.astype(np.float32))


def test_bank_is_seeded_and_the_same_work():
    a = scene.make_bank(5, 6, 8, 8, "cpu")
    b = scene.make_bank(5, 6, 8, 8, "cpu")
    assert a[0].shape == (384, 6) and a[1].shape == (384, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[1].min()) >= 0.0 and float(a[1].max()) <= 1.0
    # another seed: the same views in another order
    views = lambda bank: sorted(tuple(bank[0][i * 64].tolist())
                                for i in range(6))
    orders = {tuple(scene.make_bank(s, 6, 8, 8, "cpu")[0][::64, 3].tolist())
              for s in range(5, 12)}
    assert len(orders) > 1
    assert all(views(scene.make_bank(s, 6, 8, 8, "cpu")) == views(a)
               for s in (6, 7))


def test_analytic_occupancy():
    g = scene.analytic_occupancy(64)
    assert g.shape == (64, 64, 64)
    # the sphere's centre (0.35, 0, 0.25) and the box's (-0.5, -0.1, -0.1)
    cell = lambda p: tuple(int((v + 1.5) / 3.0 * 64) for v in p)
    assert g[cell((0.35, 0.0, 0.25))] and g[cell((-0.5, -0.1, -0.1))]
    assert not g[0, 0, 0] and not g[63, 63, 63]
    assert 0.04 < float(g.double().mean()) < 0.07


def test_host_rays_are_the_viewers_rays():
    rays = pytest.importorskip("nerf_replication_tpu_torch.datasets.rays")
    for side, theta in ((64, 10.0), (97, -77.7), (256, 150.0)):
        c2w = scene.pose_spherical(theta, -30.0, 4.0)
        f = scene.focal_for(side)
        o, d = scene.camera_rays_host(side, side, f, c2w)
        ro, rd = rays.get_rays_np(side, side, f, c2w)
        assert np.array_equal(o, ro.reshape(-1, 3))
        assert np.array_equal(d, rd.reshape(-1, 3))
        # the device tracer's rays are the same camera to rounding
        to, td = scene.camera_rays(side, side, f, torch.from_numpy(c2w))
        assert np.allclose(td.numpy(), d, atol=1e-6)
