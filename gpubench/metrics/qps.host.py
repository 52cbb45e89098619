"""Queries answered in the traced window over its seconds: the closed
loop's rate, which follows the host's speed from run to run more than
any bound can hold, so it is read here and not bounded end to end."""


def read(b):
    return b.answered / b.window_s if b.answered and b.window_s > 0 else None
