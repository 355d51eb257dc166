"""Distribution plumbing of the port: so far the fault-tolerance helpers
that serving and the training loop use (`fault_tolerance`)."""
