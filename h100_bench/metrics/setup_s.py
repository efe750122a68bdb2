"""setup_s: seconds from the process's start to the window's: importing the
port, building its kernels on a first run, making the weights and the
traffic from the seed, and warming every shape the cell uses."""


def read(run):
    return run.setup_s
