"""Port-kernel launches (``ops/kernels.py`` ``LAUNCHES``) in the window
on the clients' behalf, a query answered: the audit's shadow
executions' launches are left out."""


def read(b):
    n = sum(b.launches.values()) - b.audit_launches
    return n / b.answered if b.answered else None
