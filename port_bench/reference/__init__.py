"""The yardstick: the plain GPT-2 (gpt2.py), the comparison that decides
`correct` (compare.py) and the operation and byte counts with the
card's peaks (counts.py).  Nothing here imports the program."""
