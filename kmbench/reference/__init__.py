"""Plain PyTorch references that judge the program's results.  They
import nothing of the program."""
