"""Environment model: declarative tile-grid maps, obstacles, SDF rasterizer."""
