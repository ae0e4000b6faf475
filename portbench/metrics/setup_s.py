"""Seconds from the process's start to the window's start: imports, CUDA
context, kernel builds, weights, inputs and warm-up."""


def read(run):
    return run.setup_s
