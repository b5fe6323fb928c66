"""Migration and maintenance CLIs (``python -m
multimodal_similarity_tpu_torch tools.<name>``)."""
