"""Output tokens of the window's waves over the window's seconds, from its
start to its last token on the device's timeline, prefill time included.
The window runs every wave it starts to its end, so the rate is over whole
waves and moves smoothly with the speed of each."""


def read(run):
    n = sum(w.B * len(w.t_tokens) for w in run.waves)
    return n / run.seconds if n else None
