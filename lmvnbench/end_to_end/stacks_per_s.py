"""Stacks completed in the window over the window's seconds; a batched
call counts each of its stacks."""


def read(r):
    return r["stacks_done"] / r["window_s"]
