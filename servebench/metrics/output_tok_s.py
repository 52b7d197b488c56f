"""Output tokens emitted inside the window over its wall seconds."""


def read(run):
    return sum(s.new_tokens for s in run.window_steps()) / run.window_s
