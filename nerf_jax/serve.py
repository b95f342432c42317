"""Serving surface: load a checkpoint once, compile once, render many.

The production deployment path the reference lacks entirely (its eval.py
re-initializes everything per invocation). ``RenderService`` owns the
compiled full-image renderer — including the baked-cache (`bake`) and
occupancy-guided (`occupancy`) acceleration paths, identical to
`eval.py`'s flags, which shares `build_renderer` below — and renders
arbitrary camera poses at fixed compiled shapes (one compilation per
(H, W); the XLA executable is cached across requests).

``serve_http`` wraps a service in a stdlib threaded HTTP server:

    GET /health            -> {"status": "ok", ...}
    GET /pose/<idx>        -> PNG of orbit pose idx
    GET /render?m=<16 comma-separated floats, row-major c2w>  -> PNG

Requests serialize through one device anyway (a render IS a device-wide
program); the threaded server only overlaps PNG encode and socket IO with
device work.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

import numpy as np


def build_renderer(model, state, cfg, settings, mesh=None, bake: int = 0,
                   occupancy: int = 0, log=print):
    """The one renderer factory behind eval.py and RenderService:
    optional occupancy prior + optional baked cache + make_eval_render.
    Returns ``(renderer, render_params)`` where the renderer is called as
    ``renderer(render_params[0], render_params[1], rays_o, rays_d, key,
    viewdirs=..., hw=...)``."""
    from nerf_jax.train.step import make_eval_render

    occ = None
    if occupancy:
        from nerf_jax.models.registry import grid_domain
        from nerf_jax.ops.occupancy import (
            OccupancyGrid,
            bake_occupancy,
            sigma_field,
        )

        log(f"Baking a {occupancy}^3 occupancy prior...")
        occ_params = (
            state.fine_params
            if cfg.num_fine_samples > 0 and state.fine_params
            else state.params
        )
        dom = grid_domain(cfg)
        occ = OccupancyGrid(
            grid=bake_occupancy(
                sigma_field(model.apply, occ_params),
                grid_res=occupancy, domain=dom,
            ),
            domain=dom,
        )
    if bake:
        if not hasattr(model, "bake"):
            raise ValueError(
                f"bake: model '{cfg.model_type}' has no baked cache "
                "(fastnerf and plenoctree bake)"
            )
        log(f"Baking {cfg.model_type} field into a {bake}^3 cache...")
        # hierarchical checkpoints carry the final image quality in the
        # FINE network — bake that one (both passes then sample the same
        # baked field; importance sampling still concentrates fine t's)
        bake_params = (
            state.fine_params
            if cfg.num_fine_samples > 0 and state.fine_params
            else state.params
        )
        baked = model.bake(bake_params, grid_res=bake)
        if hasattr(baked, "apply"):   # fastnerf -> BakedFastNeRF
            baked_model, render_params = baked, (None, {})
        else:                         # plenoctree -> (PlenoxelsModel, params)
            baked_model, baked_params = baked
            render_params = (baked_params, {})
        renderer = make_eval_render(baked_model, settings, mesh=mesh,
                                    occupancy=occ)
    else:
        render_params = (state.params, state.fine_params)
        renderer = make_eval_render(model, settings, mesh=mesh,
                                    occupancy=occ)
    return renderer, render_params


class RenderService:
    """Compiled novel-view rendering from a checkpoint.

    >>> svc = RenderService.from_checkpoint("cfg.txt", "./models/nerf_model_300000")
    >>> img = svc.render_pose(c2w)           # (H, W, 3) float32 in [0, 1]
    """

    def __init__(self, cfg, model, renderer, render_params, hw, focal, ndc,
                 render_poses=None):
        import jax

        self.cfg = cfg
        self.model = model
        self._renderer = renderer
        self._params = render_params
        self.hw = hw
        self.focal = float(focal)
        self.ndc = ndc
        # LLFF: forward-facing spiral poses from the loader (a Blender-
        # style radius-4 orbit would look away from the pose cluster)
        self._render_poses = render_poses
        self._key = jax.random.key(cfg.seed)
        self._lock = threading.Lock()  # one device program at a time

    @classmethod
    def from_checkpoint(cls, config, checkpoint: str, bake: int = 0,
                        occupancy: int = 0, hw: Optional[tuple] = None,
                        log=print) -> "RenderService":
        """``config`` is a path to a reference-format config file or a
        Config instance; dataset metadata supplies H/W/focal (override
        with ``hw``) and — for LLFF — the sampling bounds, exactly like
        eval.py."""
        import jax

        from nerf_jax.config import Config, parse_config_file
        from nerf_jax.data.blender import load_blender
        from nerf_jax.train.loop import render_settings_from_config
        from nerf_jax.train.state import create_train_state
        from nerf_jax.utils.checkpoint import load_checkpoint, read_metadata

        import dataclasses

        # never mutate a caller-owned Config (checkpoint meta and dataset
        # bounds override fields below)
        cfg = (dataclasses.replace(config) if isinstance(config, Config)
               else parse_config_file(config))
        meta = read_metadata(checkpoint)
        cfg.model_type = meta.get("model_type", cfg.model_type).lower()
        if "grid_res" in meta:
            cfg.grid_res = int(meta["grid_res"])

        render_poses = None
        if cfg.dataset_type == "llff":
            from nerf_jax.data.llff import load_llff

            data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
            h, w = data["hw"]
            focal = data["focal"]
            ndc = cfg.ndc
            render_poses = np.asarray(data["render_poses"])
            cfg.near, cfg.far = ((0.0, 1.0) if ndc else
                                 (float(data["near_world"]),
                                  float(data["far_world"])))
        else:
            images, _, focal = load_blender(
                cfg.dataset_path, mode="test", single_image=True,
                white_background=cfg.white_background, half_res=cfg.half_res,
            )
            h, w = images.shape[1:3]
            ndc = False
        if hw is not None:
            # focal scales with resolution (same field of view)
            focal = focal * hw[1] / w
            h, w = hw

        model, _, state = create_train_state(cfg, jax.random.key(cfg.seed))
        state = load_checkpoint(checkpoint, state)
        settings = render_settings_from_config(cfg, ndc=ndc)
        renderer, render_params = build_renderer(
            model, state, cfg, settings, bake=bake, occupancy=occupancy,
            log=log,
        )
        return cls(cfg, model, renderer, render_params, (int(h), int(w)),
                   focal, ndc, render_poses=render_poses)

    def render_pose(self, c2w, key_idx: int = 0) -> np.ndarray:
        """Render one camera pose (c2w: (3|4, 4) world-from-camera) ->
        (H, W, 3) float32 in [0, 1]."""
        import jax
        import jax.numpy as jnp

        from nerf_jax.data.rays import compute_rays_single

        h, w = self.hw
        m = np.eye(4, dtype=np.float32)
        c2w = np.asarray(c2w, np.float32)
        m[: c2w.shape[0]] = c2w
        rays_o, rays_d = compute_rays_single(h, w, self.focal, m)
        viewdirs = None
        if self.ndc:
            from nerf_jax.ops.ndc import ndc_rays

            viewdirs = jnp.asarray(rays_d)
            rays_o, rays_d = ndc_rays(
                h, w, self.focal, 1.0, jnp.asarray(rays_o),
                jnp.asarray(rays_d))
        with self._lock:
            out = self._renderer(
                self._params[0], self._params[1],
                jnp.asarray(rays_o), jnp.asarray(rays_d),
                jax.random.fold_in(self._key, key_idx),
                viewdirs=viewdirs,
            )
        return np.clip(np.asarray(out.rgb).reshape(h, w, 3), 0.0, 1.0)

    def orbit_pose(self, idx: int) -> np.ndarray:
        if self._render_poses is not None:
            return self._render_poses[idx % len(self._render_poses)]
        from nerf_jax.data.poses import spherical_orbit

        poses = spherical_orbit(self.cfg.num_render_poses)
        return poses[idx % len(poses)]


def _png_bytes(img01: np.ndarray) -> bytes:
    from nerf_jax.utils.png import encode_png

    return encode_png((img01 * 255).astype(np.uint8))


def serve_http(service: RenderService, port: int = 8000,
               host: str = "127.0.0.1", log=print):
    """Blocking threaded HTTP server over a RenderService (see module
    docstring for routes). Returns only on KeyboardInterrupt. Binds
    loopback by default — the endpoint is unauthenticated; widen with
    ``host="0.0.0.0"`` deliberately."""
    server = make_http_server(service, port, host)
    log(f"Serving {service.cfg.model_type} renders on "
        f"{host or '0.0.0.0'}:{server.server_address[1]} "
        "(/health, /pose/<i>, /render?m=...)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


def make_http_server(service: RenderService, port: int = 0,
                     host: str = "127.0.0.1"):
    """Construct (without starting) the HTTP server — tests drive it via
    ``threading.Thread(target=server.serve_forever)``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # request parsing -> 400; render/encode failures -> 500 (a
            # device error is not the client's fault and must page, not
            # be retried-away as a bad request)
            try:
                url = urlparse(self.path)
                if url.path == "/health":
                    h, w = service.hw
                    body = json.dumps({
                        "status": "ok",
                        "model_type": service.cfg.model_type,
                        "hw": [h, w],
                    }).encode()
                    return self._send(200, body, "application/json")
                if url.path.startswith("/pose/"):
                    idx = int(url.path.split("/")[-1])
                    c2w, key_idx = service.orbit_pose(idx), idx
                elif url.path == "/render":
                    q = parse_qs(url.query)
                    vals = [float(x) for x in q["m"][0].split(",")]
                    if len(vals) not in (12, 16):
                        raise ValueError("m wants 12 or 16 floats")
                    c2w, key_idx = (
                        np.asarray(vals, np.float32).reshape(-1, 4), 0)
                else:
                    return self._send(404, b"not found", "text/plain")
            except Exception as e:  # noqa: BLE001 — malformed request
                return self._send(
                    400, f"{type(e).__name__}: {e}".encode(), "text/plain")
            try:
                img = service.render_pose(c2w, key_idx=key_idx)
                return self._send(200, _png_bytes(img), "image/png")
            except Exception:  # noqa: BLE001 — server-side failure
                import traceback

                traceback.print_exc()
                return self._send(500, b"render failed", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    """``nerf-jax-serve --config cfg.txt --checkpoint ckpt [--port 8000]
    [--bake RES] [--occupancy RES] [--hw H W]``"""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default loopback; the endpoint "
                             "is unauthenticated — widen deliberately)")
    parser.add_argument("--bake", type=int, default=0)
    parser.add_argument("--occupancy", type=int, default=0)
    parser.add_argument("--hw", type=int, nargs=2, default=None)
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    svc = RenderService.from_checkpoint(
        args.config, args.checkpoint, bake=args.bake,
        occupancy=args.occupancy, hw=tuple(args.hw) if args.hw else None,
    )
    # compile before accepting traffic
    svc.render_pose(svc.orbit_pose(0))
    serve_http(svc, port=args.port, host=args.host)


if __name__ == "__main__":
    main()
