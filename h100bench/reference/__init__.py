"""The plain reference: what the program computes, worked out again in numpy and torch."""
