# launch: the port's entry points (``serve``).
