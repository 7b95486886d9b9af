"""Seconds from the process's start to the window's: imports, the weights
drawn, the kernel library loaded (or built), quantization, warm-up, graph
capture, and the sessions' join and delay warm-up."""


def read(run):
    return run.setup_s
