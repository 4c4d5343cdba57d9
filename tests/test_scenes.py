"""Seeded synthetic inputs (extractorb.sim): the numpy warp against
OpenCV, seed determinism, FAST corner supply on a rendered view, and the
ground truth of the long-session solver problems."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.config import ORBConfig
from extractorb.frontend.extractor import ORBExtractor
from extractorb.sim import problems, scenes


def _homography(tex, k, plane):
    A_far, A_near = scenes._planes(tex)
    R = scenes.so3_exp([0.01 * k, 0.015 * k, -0.005 * k])
    t = -R @ np.array([0.12 * k, 0.015 * k, 0.01 * k])
    A = A_far if plane == "far" else A_near
    return scenes.K @ (R @ A + t[:, None] @ scenes._E3)


@pytest.mark.parametrize("k", [0, 3, 7])
@pytest.mark.parametrize("border", ["replicate", "constant"])
def test_warp_within_one_grey_level_of_cv2(scene_texture, k, border):
    plane = "far" if border == "replicate" else "near"
    M = _homography(scene_texture, k, plane)
    ours = scenes.warp_bilinear(scene_texture, M, border=border)
    flag = cv2.BORDER_REPLICATE if border == "replicate" else cv2.BORDER_CONSTANT
    ref = cv2.warpPerspective(scene_texture, M, (scenes.W, scenes.H),
                              flags=cv2.INTER_LINEAR, borderMode=flag)
    diff = np.abs(ours.astype(int) - ref.astype(int))[1:-1, 1:-1]
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("k", [0, 5])
def test_coverage_mask_matches_cv2_nearest(scene_texture, k):
    M = _homography(scene_texture, k, "near")
    ones = np.full_like(scene_texture, 255)
    ref = cv2.warpPerspective(ones, M, (scenes.W, scenes.H),
                              flags=cv2.INTER_NEAREST) > 128
    np.testing.assert_array_equal(scenes.warp_mask(scene_texture.shape, M), ref)


def test_texture_is_a_function_of_its_seed():
    a, b = scenes.texture(3, (256, 512)), scenes.texture(3, (256, 512))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (256, 512) and a.dtype == np.uint8
    assert (a != scenes.texture(4, (256, 512))).mean() > 0.5
    # dead leaves cover the whole grey range with real contrast
    assert a.std() > 40 and a.min() < 30 and a.max() > 225


@pytest.mark.parametrize("render", [
    lambda tex: scenes.render_sequence(tex, 3)[0],
    lambda tex: scenes.render_stereo_pair(tex, 2)[1],
    lambda tex: scenes.render_rgbd(tex, 2)[1],
    lambda tex: scenes.render_vi_sequence(tex, 2)[0],
    lambda tex: scenes.render_loop_sequence(tex, 4)[0],
], ids=["mono", "stereo", "rgbd", "vi", "loop"])
def test_scenes_are_deterministic(render):
    a = render(scenes.texture(5, (256, 512)))
    b = render(scenes.texture(5, (256, 512)))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == (scenes.H, scenes.W)
        np.testing.assert_array_equal(x, y)


def test_rendered_view_fills_every_level_budget(scene_texture):
    """A 640x480 view of the seeded scene supplies enough FAST corners
    for the 1000-feature budget at every pyramid level."""
    cfg = ORBConfig(n_features=1000)
    frame = scenes.render_sequence(scene_texture, 1)[0][0]
    f = ORBExtractor(cfg, octree="device")(jnp.asarray(frame))
    valid = np.asarray(f.valid)
    per_level = np.bincount(np.asarray(f.octave)[valid], minlength=cfg.n_levels)
    assert (per_level >= np.asarray(cfg.features_per_level)).all(), per_level


def test_rgbd_depth_is_exact_on_the_planes(scene_texture):
    frames, depths, poses = scenes.render_rgbd(scene_texture, 1)
    # first camera is the world frame: the far wall is at depth 5 on the
    # optical axis unless the near poster covers it
    R, t = poses[0]
    assert np.allclose(R, np.eye(3)) and np.allclose(t, 0)
    assert set(np.unique(np.round(depths[0][240, :], 3))) <= {3.0, 5.0}


def test_vi_imu_window_sampling():
    w = scenes.vi_imu_window(0.1, 0.2, 200.0)
    assert len(w) == 21
    assert w[0][0] == pytest.approx(0.1) and w[-1][0] == pytest.approx(0.2)
    # at rest the specific force is gravity's reaction (9.81 m/s^2 up)
    acc = np.array([a for _, a, _ in w])
    assert np.all(np.abs(np.linalg.norm(acc, axis=1) - 9.81) < 6.0)


def test_ba_problem_observations_match_truth():
    prob, truth = problems.ba_problem(1, n_kf=12, n_pts=240, obs_per_pt=5)
    kf, mp = np.asarray(prob.obs_kf), np.asarray(prob.obs_mp)
    pc = np.einsum("oij,oj->oi", truth.R[kf], truth.points[mp]) + truth.t[kf]
    uv = np.asarray(problems.project_pinhole(pc.T))
    err = np.linalg.norm(uv - np.asarray(prob.obs_uv), axis=1)
    assert len(kf) > 0.9 * 240 * 5
    assert 0.3 < err.mean() < 1.0          # 0.5 px noise per axis
    # the initial guess is perturbed, keyframe 0 is fixed and exact
    assert np.asarray(prob.fixed_kf)[0]
    np.testing.assert_allclose(np.asarray(prob.t)[0], truth.t[0], atol=1e-6)
    assert np.abs(np.asarray(prob.t)[1:] - truth.t[1:]).max() > 1e-3


def test_pose_graph_problem_is_consistent_at_truth():
    prob, truth = problems.pose_graph_problem(2, n_kf=30, covis=3, n_loops=8)
    v = np.asarray(prob.edge_valid)
    assert v.sum() >= 29 and len(v) % 128 == 0
    i, j = np.asarray(prob.edge_i)[v], np.asarray(prob.edge_j)[v]
    mR, mt = np.asarray(prob.m_R)[v], np.asarray(prob.m_t)[v]
    # m_ij * S_i == S_j at the ground truth
    np.testing.assert_allclose(mR @ truth.R[i], truth.R[j], atol=1e-5)
    np.testing.assert_allclose(
        np.einsum("eij,ej->ei", mR, truth.t[i]) + mt, truth.t[j], atol=1e-4)
