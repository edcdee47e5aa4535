"""Mean host ms of a mask frame in the port's span ``masks.keep`` (the
softmax, the thresholds, the kept masks' resize, their copies to the host
and the empty-mask filter, ``predict_masks_multi``) less the waits on the
card inside it (its ``sync.*`` spans), over the window's untraced
frames."""

from port_spans import frame_host_ms


def read(ctx):
    return frame_host_ms(ctx, "masks.keep")
