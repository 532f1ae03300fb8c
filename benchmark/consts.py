"""Token ids the traffic and the references use: the values of the
port's `constants.py`, written here so that nothing of the yardstick
imports the program. The configurations' vocabularies (131,072 rows) hold
them as ordinary rows."""

IGNORE_INDEX = -100
IMAGE_SENTINEL = -200       # where a sample's image goes
BOS_ID = 128000             # <|begin_of_text|>
EOT_ID = 128009             # <|eot_id|>
EOS_IDS = (128001, 128009)  # stop generation
IM_START_ID = 128256        # <image_start>
IM_END_ID = 128257          # <image_end>
