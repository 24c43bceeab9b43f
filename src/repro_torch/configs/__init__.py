"""Architecture configs (data), one module per architecture."""
