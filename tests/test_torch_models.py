"""colmap_tpu_torch camera models against colmap_tpu's, on the CPU in float64.

The same inputs, made from a numpy seed, go through colmap_tpu's JAX
img_from_cam and the port's torch one, for every one of the 18 models.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.sensor import models as jm
from colmap_tpu_torch.sensor import models as tm

ALL_MODELS = [int(m) for m in jm.CameraModelId if m != jm.CameraModelId.INVALID]


def _random_params(model_id, n, rng):
    """(n, P) per-row parameters around the model's defaults."""
    base = jm.initialize_params(model_id, 1280.0, 1024, 768)
    params = np.tile(base, (n, 1))
    mid = jm.CameraModelId(model_id)
    if mid == jm.CameraModelId.EQUIRECTANGULAR:
        return params
    for i in jm.focal_length_idxs(model_id):
        params[:, i] *= rng.uniform(0.9, 1.1, n)
    for i in jm.principal_point_idxs(model_id):
        params[:, i] += rng.uniform(-20, 20, n)
    extra = list(jm.extra_params_idxs(model_id))
    if mid == jm.CameraModelId.FOV:
        params[:, extra[0]] = rng.uniform(0.5, 1.0, n)
    elif mid == jm.CameraModelId.EUCM:
        params[:, 4] = rng.uniform(0.3, 0.7, n)
        params[:, 5] = rng.uniform(0.8, 1.2, n)
    else:
        for i in extra:
            params[:, i] = rng.uniform(-0.02, 0.02, n)
    return params


def _random_points(n, rng):
    w = rng.uniform(1.0, 5.0, n)
    uv = rng.uniform(-1.0, 1.0, (n, 2)) * w[:, None]
    uvw = np.concatenate([uv, w[:, None]], axis=1)
    uvw[:5] *= -1.0  # behind the camera: exercises the cheirality mask
    uvw[5, :2] = 0.0  # on the optical axis
    return uvw


@pytest.mark.parametrize("model_id", ALL_MODELS, ids=[jm.MODEL_ID_TO_NAME[m] for m in ALL_MODELS])
def test_img_from_cam_matches_jax(model_id):
    """Pixel coordinates to rtol 1e-10 (atol 1e-9 px), validity masks equal."""
    rng = np.random.default_rng(model_id)
    n = 64
    params = _random_params(model_id, n, rng)
    uvw = _random_points(n, rng)
    for cheirality in (True, False):
        jxy, jvalid = jm.img_from_cam(model_id, jnp.asarray(params), jnp.asarray(uvw),
                                      check_cheirality=cheirality)
        txy, tvalid = tm.img_from_cam(model_id, torch.from_numpy(params),
                                      torch.from_numpy(uvw), check_cheirality=cheirality)
        np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-10, atol=1e-9)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # One parameter row for all points.
    jxy, _ = jm.img_from_cam(model_id, jnp.asarray(params[0]), jnp.asarray(uvw))
    txy, _ = tm.img_from_cam(model_id, torch.from_numpy(params[0]), torch.from_numpy(uvw))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-10, atol=1e-9)


def test_model_tables_match_jax():
    """Names, parameter counts, index helpers and default parameters agree."""
    assert tm.MODEL_NAME_TO_ID == {k: int(v) for k, v in jm.MODEL_NAME_TO_ID.items()}
    for m in ALL_MODELS:
        assert tm.model_num_params(m) == jm.model_num_params(m)
        assert tm.focal_length_idxs(m) == jm.focal_length_idxs(m)
        assert tm.principal_point_idxs(m) == jm.principal_point_idxs(m)
        assert tm.extra_params_idxs(m) == jm.extra_params_idxs(m)
        np.testing.assert_array_equal(tm.initialize_params(m, 900.0, 640, 480),
                                      jm.initialize_params(m, 900.0, 640, 480))
        p = jm.initialize_params(m, 900.0, 640, 480)
        assert float(tm.mean_focal_length(m, p)) == float(jm.mean_focal_length(m, p))
