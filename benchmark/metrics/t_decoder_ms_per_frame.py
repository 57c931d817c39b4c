"""t_decoder_ms_per_frame: the decoder's milliseconds a frame
(``SceneRenderer.profile``: CUDA events around the decodes, the fastest of
three passes of one scene after the traced slice, cropped when the scene's
plan crops), over the scene's N frames."""


def read(r):
    return r.extra.get("t_decoder_ms_per_frame")
