"""Model configurations (this slice: the paper's vision models)."""
