"""render_fps: every frame handed to the host as uint8 in the window,
divided by the window's seconds (the window ends with its last scene)."""


def read(r):
    return r.frames / r.window_s if r.frames else None
