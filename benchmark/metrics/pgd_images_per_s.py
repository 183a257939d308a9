"""Bayesian PGD throughput: the images of the window's finished batches over
the window's seconds, from its start to the end of its last batch. Host clock."""


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd":
        return None
    return ctx["window"]["units"] / ctx["window"]["seconds"]
