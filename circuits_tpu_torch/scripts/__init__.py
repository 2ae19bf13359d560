"""Entry points of the port that run one experiment each."""
