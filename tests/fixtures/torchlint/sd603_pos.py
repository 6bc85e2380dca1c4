"""SD603 positive: raw mesh-axis string literals outside parallel/ — a
mesh dimension lookup, a mesh subscript, a layout group, a coordinate
lookup, and an axis-named parameter default (5 sites)."""


def fsdp_group(mesh):
    return mesh.get_group("fsdp")


def pipe_mesh(mesh):
    return mesh["pipe"]


def model_group(layout):
    return layout.axis("model")


def seq_index(layout):
    return layout.coords["seq"]


def ring(x, seq_axis="seq"):
    return x, seq_axis
