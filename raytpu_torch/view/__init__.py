"""Live interactive viewer (the reference's realtime SDL loop), raytracer
half."""

from raytpu_torch.view.server import ViewerApp, serve

__all__ = ["ViewerApp", "serve"]
