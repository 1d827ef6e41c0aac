"""Vision transforms (reference: $DL/transform/vision)."""
