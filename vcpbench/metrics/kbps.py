"""kbps: bytes of the video track's samples x 8 over the content's
seconds, read from the sampled output by the benchmark's MP4 reader."""


def read(obs):
    return obs["check"]["kbps"]
