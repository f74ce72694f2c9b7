"""The window's valid k-mer windows a second, as ``kmers_per_s`` takes it,
for the cells whose runs spread too widely to hold it end to end."""


def read(ctx):
    return ctx.kmers_per_s or None
