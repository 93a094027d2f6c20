"""Set-up seconds: from the start of the process to the window: drawing the
inputs, making the weights, building (and, on a fresh checkout, compiling)
the port, and warming up every shape."""


def read(rec):
    return rec.setup_s
