"""Render runtime: framebuffer accumulation and the RenderingContext entry point."""
