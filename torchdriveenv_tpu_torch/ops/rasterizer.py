"""Birdview palette and culling constants (port of the constants of
``torchdriveenv_tpu/ops/rasterizer.py``). The SDF-grid rasterizer
``render_egocentric`` of that module is not ported yet; the observation path
uses ``ops/rasterizer_cuda.py``."""

from __future__ import annotations

# palette (RGB, 0..255)
COLOR_BACKGROUND = (15.0, 15.0, 20.0)
COLOR_ROAD = (90.0, 90.0, 95.0)
COLOR_WAYPOINT = (40.0, 220.0, 90.0)
COLOR_NPC = (60.0, 120.0, 235.0)
COLOR_EGO = (230.0, 60.0, 50.0)
COLOR_LIGHT = ((40.0, 200.0, 60.0),     # green
               (235.0, 200.0, 40.0),    # yellow
               (235.0, 50.0, 40.0))     # red
WAYPOINT_RADIUS = 2.0      # meters
STOPLINE_HALF_THICK = 0.7  # meters
RENDER_MAX_AGENTS = 16     # per-pixel OBB tests after visibility culling
RENDER_MAX_LIGHTS = 4      # per-pixel stopline tests after visibility culling
RENDER_MAX_WAYPOINTS = 8   # per-pixel disc tests after visibility culling
