"""Device ops of the port: the realignment DP kernel and the code around it."""
