"""Bundle adjustment: recover perturbed poses/points on synthetic tracks.

New scope vs the reference (TMVS has no BA; poses come fixed from
VisualSFM).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models.camera import _np_quat_to_rotation
from pais_mvs_tpu.ops.bundle import (BaProblem, bundle_adjust,
                                     bundle_adjust_sharded, _exp_so3)
from pais_mvs_tpu.parallel.mesh import make_mesh, PATCH_AXIS


def _problem(noise_rot=0.01, noise_c=0.02, noise_p=0.02, M=64, seed=4):
    sc = make_scene(num_cams=4, width=320, height=240, num_seeds=M + 20,
                    seed=seed)
    C = 4
    Rs, centers, focals, pps = [], [], [], []
    for i, p in enumerate(sc.params):
        Rs.append(_np_quat_to_rotation(p.quaternion))
        centers.append(p.center)
        focals.append(p.focal)
        h, w = sc.images[i].shape[:2]
        pps.append(np.array([w >> 1, h >> 1], dtype=np.float64))
    rng = np.random.default_rng(seed)
    M = min(M, len(sc.seed_centers))
    prob_true = BaProblem(
        R=jnp.asarray(np.stack(Rs), jnp.float32),
        center=jnp.asarray(np.stack(centers), jnp.float32),
        focal=jnp.asarray(np.stack(focals), jnp.float32),
        principal=jnp.asarray(np.stack(pps), jnp.float32),
        points=jnp.asarray(sc.seed_centers[:M], jnp.float32),
        obs=jnp.asarray(sc.seed_img_points[:M], jnp.float32),
        mask=jnp.asarray(sc.seed_cam_masks[:M]))
    # perturb every camera except 0 (the gauge anchor) + all points
    w = rng.normal(scale=noise_rot, size=(C, 3)); w[0] = 0
    dc = rng.normal(scale=noise_c, size=(C, 3)); dc[0] = 0
    Rn = np.asarray(_exp_so3(jnp.asarray(w, jnp.float32))) @ np.stack(Rs)
    pts = sc.seed_centers[:M] + rng.normal(scale=noise_p, size=(M, 3))
    prob = prob_true._replace(
        R=jnp.asarray(Rn, jnp.float32),
        center=prob_true.center + jnp.asarray(dc, jnp.float32),
        points=jnp.asarray(pts, jnp.float32))
    return prob, prob_true


def test_bundle_adjust_converges():
    prob, true = _problem()
    res = bundle_adjust(prob, num_iters=8, damping=1e-4)
    h = np.asarray(res.rms_history)
    assert h[0] > 1.0, f"perturbation should reproject badly, rms={h[0]}"
    assert h[-1] < 0.05, f"BA failed to converge: {h}"
    # camera 0 pinned (gauge)
    np.testing.assert_allclose(np.asarray(res.center)[0],
                               np.asarray(prob.center)[0], atol=1e-6)
    # recovered centers close to truth up to the (unobservable) scale
    # gauge: align scale about the pinned camera before comparing
    rc = np.asarray(res.center)
    tc = np.asarray(true.center)
    s = np.linalg.norm(tc[1] - tc[0]) / np.linalg.norm(rc[1] - rc[0])
    aligned = (rc - rc[0]) * s + tc[0]
    err = np.linalg.norm(aligned - tc, axis=-1)
    assert err.max() < 2e-3, err


def test_bundle_adjust_zero_noise_stays_put():
    prob, true = _problem(noise_rot=0.0, noise_c=0.0, noise_p=0.0)
    res = bundle_adjust(prob, num_iters=3, damping=1e-4)
    h = np.asarray(res.rms_history)
    assert h[-1] <= h[0] + 1e-3
    assert h[-1] < 0.02


def test_bundle_adjust_sharded_matches_single():
    prob, true = _problem(M=64)
    mesh = make_mesh((8, 1))
    res1 = bundle_adjust(prob, num_iters=5, damping=1e-4)
    res8 = bundle_adjust_sharded(prob, mesh, PATCH_AXIS, num_iters=5,
                                 damping=1e-4)
    # the distributed Schur reduction must land where the single-device
    # solve lands; intermediate f32 trajectories may differ by summation
    # order, so compare the converged state
    assert np.asarray(res8.rms_history)[-1] < 1e-3
    assert np.asarray(res1.rms_history)[-1] < 1e-3
    # both live in the same gauge family: compare after scale alignment
    # about the pinned camera (scale is unobservable from reprojection)
    c8, c1 = np.asarray(res8.center), np.asarray(res1.center)
    s = np.linalg.norm(c1[1] - c1[0]) / np.linalg.norm(c8[1] - c8[0])
    aligned = (c8 - c8[0]) * s + c1[0]
    np.testing.assert_allclose(aligned, c1, atol=2e-3)
    np.testing.assert_allclose(np.asarray(res8.R),
                               np.asarray(res1.R), atol=2e-3)
