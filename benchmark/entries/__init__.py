"""One module per entry of the program that a traffic mix drives, found
by the entry's name. Each opens a session of ``ideepcolor_tpu_torch`` as a
user would and makes the one call that an action times."""
