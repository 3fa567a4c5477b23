"""Host-side references (numpy only): the acceptance tests' error norms
(:mod:`.oracle`) and the float64 mirror of the RL pipeline (:mod:`.numpy_ref`)."""
