"""Process start to the first timed request, in s: imports, the kernels'
build or load, the keys made and packed, the inputs encrypted, the warm-up."""


def read(window):
    return window.setup_s
