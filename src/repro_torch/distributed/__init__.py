"""Distribution plumbing of the port: so far the fault-tolerance helpers
that serving uses (`fault_tolerance`)."""
