"""Host-side data transforms: the vision image pipeline (counterpart of
``bigdl_tpu/transform``)."""
