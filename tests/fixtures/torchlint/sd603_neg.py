"""SD603 negative: the same sites spelled through the parallel/mesh
AXIS_* constants, a layout group that is no mesh axis, and an axis
spelling in a non-axis position."""
from bert_pytorch_tpu_torch.parallel.mesh import (AXIS_FSDP, AXIS_MODEL,
                                                  AXIS_PIPE, AXIS_SEQ)


def fsdp_group(mesh):
    return mesh.get_group(AXIS_FSDP)


def pipe_mesh(mesh):
    return mesh[AXIS_PIPE]


def groups(layout):
    return layout.axis(AXIS_MODEL), layout.axis("grad")


def seq_index(layout):
    return layout.coords[AXIS_SEQ]


def tag(kind="data_loader"):
    # An arbitrary string that merely CONTAINS an axis spelling in a
    # non-axis position is not a site.
    return kind
