"""Graph-support kernel factory (supports from adjacency/flow graphs)."""
