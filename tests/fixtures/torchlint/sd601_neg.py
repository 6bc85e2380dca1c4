"""SD601 negative: registered mesh axes through the AXIS_* constants (a
local one and an imported one), a layout group by its name, an int mesh
dimension, and dynamic names."""
from bert_pytorch_tpu_torch.parallel.mesh import AXIS_MODEL

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"


def fsdp_group(mesh):
    return mesh.get_group(AXIS_FSDP)


def hsdp_mesh(mesh):
    return mesh[(AXIS_DATA, AXIS_FSDP)]


def groups(layout):
    return layout.axis(AXIS_MODEL), layout.axis("grad")


def first_dim(mesh):
    return mesh.get_group(0)


def dynamic(mesh, layout, name):
    # A computed name is out of this tier's reach: proven statically
    # knowable or skipped, never guessed.
    return mesh.get_group(name), layout.axis(name)
