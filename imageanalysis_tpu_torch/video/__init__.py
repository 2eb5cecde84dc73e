from . import camera, correlate, frame_motion, djilog, horizon, hud  # noqa: F401
