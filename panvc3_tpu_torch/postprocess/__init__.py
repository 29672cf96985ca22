"""Post-processing utilities (the reference's Python script layer): copies
of ``panvc3_tpu.postprocess``, their C codec from the port's own build."""
