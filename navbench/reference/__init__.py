"""Plain references that decide `correct`; none imports the program."""
