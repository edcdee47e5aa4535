"""Mean host ms of a mask frame in the port's span ``m2f.pixel_decoder``
(the input projections, the 6 MSDA encoder layers on K1 and the FPN tail,
``Mask2Former.forward``) less the waits on the card inside it (its
``sync.*`` spans), over the window's untraced frames."""

from port_spans import frame_host_ms


def read(ctx):
    return frame_host_ms(ctx, "m2f.pixel_decoder")
