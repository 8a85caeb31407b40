"""Data layer: object stores, codecs, augmentation and datasets (numpy)."""
