"""The LM substrate: layers, attention, MoE over ``core.partition
.bucket_matrix``, the decoder transformer, the model API and the
converter from the reference's parameter trees (port of
``src/repro/models``)."""
