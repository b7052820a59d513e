from .inference import inference_main

if __name__ == "__main__":
    inference_main()
