"""setup_s: process start to window start (imports, CUDA start, kernel
and host-library builds or loads, content and Y4M write, warm-up)."""


def read(obs):
    return obs["setup_s"]
