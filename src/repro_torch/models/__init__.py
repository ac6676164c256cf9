"""The paper's small models, batched over a leading client axis."""
