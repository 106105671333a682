"""Train state, train step and the fault-tolerant loop of the port."""
