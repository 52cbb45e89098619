"""Mean milliseconds a query waited at the serving layer's heavy-slot
gate before its flight record opened (the flight phase ``admit``, the
``serving.admit`` span's time), a query answered."""

from gpubench.metrics import phase_mean_ms


def read(b):
    return phase_mean_ms(b, ("admit",))
