"""SD601 positive: axis names no mesh or layout has — a layout group
handed to a DeviceMesh, and a typo'd layout group."""


def batch_group(mesh):
    # 'batch' is a layout GROUP, not a mesh dimension: the DeviceMesh has
    # none of that name, and the lookup fails only under a mesh that
    # reaches this path.
    return mesh.get_group("batch")


def model_group(layout):
    return layout.axis("modle")
