"""SD602 positive: a split table whose logical names have no model rule —
one with no rule at all (it would silently replicate), and one whose rule
puts it on fsdp, not on the model axis the split runs over."""

SPLITS = (
    (r"\.attention\.(query|key|value)\.weight$", 0, "heads"),
    (r"\.intermediate\.dense\.weight$", 0, "hidden_bad"),
    (r"\.embeddings\.word_embeddings\.weight$", 1, "embed"),
)
