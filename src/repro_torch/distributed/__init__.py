"""Distribution of the port: the process-wide mesh context, the
collectives and the partition rules."""
