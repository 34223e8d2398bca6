"""The hand-written fused AdamW pass: its wrappers and the part-table
packer (the plain version is ``train/optimizer.py``'s ``_global_norm``
and ``_update``)."""
