"""Mean host ms of a mask frame in the port's span ``masks.encode`` (the
frame's upload, its resize to the network's input, its normalisation:
``Mask2FormerBackend._encode``) less the waits on the card inside it (its
``sync.*`` spans), over the window's untraced frames."""

from port_spans import frame_host_ms


def read(ctx):
    return frame_host_ms(ctx, "masks.encode")
