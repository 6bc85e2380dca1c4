"""SD602 negative: every logical name of the split table resolves to a
model rule — directly and through a module constant — and a table built
at run time is out of reach."""

HEADS = "heads"

SPLITS = (
    (r"\.attention\.(query|key|value)\.(weight|bias)$", 0, HEADS),
    (r"\.intermediate\.dense\.(weight|bias)$", 0, "mlp"),
    (r"^predictions\.bias$", 0, "vocab"),
    (r"^bert\.pooler\.dense_act\.dense\.(weight|bias)$", 0, "embed_out"),
)
EXTRA_SPLITS = tuple((p, d, a) for p, d, a in SPLITS)
