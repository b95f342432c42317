from nerf_jax.render.renderer import (
    RenderSettings,
    RenderOutput,
    render_rays,
    render_image,
)

__all__ = ["RenderSettings", "RenderOutput", "render_rays", "render_image"]
