"""SVI training throughput: the training images of the window's finished
epochs over the window's seconds. Host clock."""


def read(ctx):
    if ctx["traffic"]["kind"] != "svi":
        return None
    return ctx["window"]["units"] / ctx["window"]["seconds"]
