"""setup_s: process start to window start: importing torch and the
program, the CUDA context, kernels built or loaded from the checkout's
cache, the inputs written and the warm-up job."""


def read(run):
    return run.setup_s
