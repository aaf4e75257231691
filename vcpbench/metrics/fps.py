"""fps: frames of all tasks in the window over the window's whole time,
from the first task's start to the last task's end, verify included."""


def read(obs):
    t0, t1 = obs["window"]
    return sum(t.frames for t in obs["tasks"]) / (t1 - t0)
