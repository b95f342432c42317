"""Serving surface (nerf_jax/serve.py): compiled RenderService + the
stdlib HTTP wrapper."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from nerf_jax.serve import RenderService, make_http_server
from tests.synthetic import make_synthetic_blender_scene


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    from nerf_jax.config import Config
    from nerf_jax.train.loop import fit

    root = tmp_path_factory.mktemp("scene")
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=2,
                                 num_val=1, num_test=1)
    save = tmp_path_factory.mktemp("models")
    cfg = Config(
        dataset_path=str(root), model_type="nerf", hidden_dim=32,
        pos_encoding_dim=2, dir_encoding_dim=1, num_samples=4,
        num_random_rays=64, donate_state=False,
        log_interval=5, val_interval=100, save_interval=100,
        num_render_poses=4,
        save_path=str(save), log_dir=str(tmp_path_factory.mktemp("logs")),
    )
    fit(cfg, max_steps=5, enable_tensorboard=False)
    return RenderService.from_checkpoint(
        cfg, os.path.join(str(save), "nerf_model_000005"))


def test_render_pose_shape_and_range(service):
    img = service.render_pose(service.orbit_pose(0))
    assert img.shape == (16, 16, 3)
    assert img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    # a second pose reuses the compiled executable (same shapes) and
    # renders a different view
    img2 = service.render_pose(service.orbit_pose(1), key_idx=1)
    assert not np.array_equal(img, img2)


def test_custom_resolution(service, tmp_path_factory):
    """The hw override re-derives focal (same field of view) and renders
    at the requested shape."""
    save = service.cfg.save_path
    svc = RenderService.from_checkpoint(
        service.cfg, os.path.join(save, "nerf_model_000005"), hw=(8, 8))
    assert svc.hw == (8, 8)
    np.testing.assert_allclose(svc.focal, service.focal * 8 / 16, rtol=1e-6)
    img = svc.render_pose(svc.orbit_pose(0))
    assert img.shape == (8, 8, 3)


def test_http_endpoints(service):
    server = make_http_server(service, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health") as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["hw"] == [16, 16]

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/pose/0") as r:
            png = r.read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"

        m = ",".join(str(x) for x in np.eye(4)[:3].reshape(-1))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/render?m={m}") as r:
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"

        # malformed request -> 400, not a crashed server
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/render?m=1,2")
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health") as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
