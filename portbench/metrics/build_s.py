"""build_s: seconds of the port's IvfBackend.build (k-means, cell split,
cell-major layout, int8 codes), host clock ending in a synchronize."""


def read(run):
    return run.build_s
