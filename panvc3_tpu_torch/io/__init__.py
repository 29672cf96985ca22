"""SAM and FASTA I/O of the port."""
