"""Tools: measurement scripts for the card (each runs only where CUDA is),
the perplexity gate, and the offline weight tools (repacker, converters,
golden files), which run on the host."""
