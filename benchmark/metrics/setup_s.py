"""Set-up: seconds from the process's start to the first timed unit of work
(imports, the kernels loaded or built, the inputs made, every shape warmed
up; for SVI also the first steps, which the check compares). Host clock."""


def read(ctx):
    return ctx["setup_s"]
