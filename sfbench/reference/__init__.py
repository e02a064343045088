"""The plain reference of the benchmark: the two Fig 6 fabrics, their
routing tables, the traffic patterns and the open-loop flit simulator,
in plain numpy and torch.  It imports nothing of the program under test
and takes nothing the program has made."""
