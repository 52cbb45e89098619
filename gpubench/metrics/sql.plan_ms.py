"""Mean milliseconds of a SQL statement's planning, parse to plan
(``pilosa_sql_plan_cost_ms``, its sum over its count in the window)."""


def read(b):
    n = b.counters["sql_plan_count"]
    return b.counters["sql_plan_ms_sum"] / n if n else None
