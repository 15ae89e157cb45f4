"""setup_s (end to end, host clock): process start to the window's start:
imports, kernel build or load, the drive's simulation, binning and upload,
graph captures and the warm-up frames."""


def read(run):
    return run["setup_s"]
