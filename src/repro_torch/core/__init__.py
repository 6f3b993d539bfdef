"""Weight-sharing core: k-means dictionaries, int4 packing, the params
containers and the conv front end."""
